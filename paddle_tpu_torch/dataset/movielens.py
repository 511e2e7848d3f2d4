"""MovieLens-1M schema dataset (reference: python/paddle/dataset/movielens.py).

Samples are user features + movie features + [[rating]]:
    [user_id, gender(0/1), age_idx, job_id,
     movie_id, [category_ids...], [title_word_ids...], [rating]]
matching `usr.value() + mov.value() + [[rating]]` (reference :167).
The surrogate draws ratings from latent user/movie factors so a
factorization model trains; metadata accessors mirror the reference.
"""

from __future__ import annotations

import numpy as np

__all__ = [
    "train", "test", "get_movie_title_dict", "max_movie_id", "max_user_id",
    "age_table", "movie_categories", "max_job_id", "user_info", "movie_info",
]

age_table = [1, 18, 25, 35, 45, 50, 56]

_N_USERS = 400
_N_MOVIES = 500
_N_JOBS = 21
_CATEGORIES = [
    "Action", "Adventure", "Animation", "Children's", "Comedy", "Crime",
    "Documentary", "Drama", "Fantasy", "Film-Noir", "Horror", "Musical",
    "Mystery", "Romance", "Sci-Fi", "Thriller", "War", "Western",
]
_TITLE_WORDS = 512
_DIM = 6


class MovieInfo:
    """reference movielens.MovieInfo"""

    def __init__(self, index, categories, title):
        self.index = int(index)
        self.categories = categories
        self.title = title

    def value(self):
        return [self.index,
                [_CATEGORIES.index(c) for c in self.categories],
                [_title_dict()[w.lower()] for w in self.title.split()]]


class UserInfo:
    """reference movielens.UserInfo"""

    def __init__(self, index, gender, age, job_id):
        self.index = int(index)
        self.is_male = gender == "M"
        self.age = age_table.index(int(age))
        self.job_id = int(job_id)

    def value(self):
        return [self.index, 0 if self.is_male else 1, self.age, self.job_id]


_TITLE_DICT = None
_USERS = None
_MOVIES = None
_FACTORS = None


def _title_dict():
    global _TITLE_DICT
    if _TITLE_DICT is None:
        _TITLE_DICT = {"t%d" % i: i for i in range(_TITLE_WORDS)}
    return _TITLE_DICT


def _meta():
    global _USERS, _MOVIES, _FACTORS
    if _USERS is None:
        rng = np.random.RandomState(77)
        _USERS = {
            i: UserInfo(i, "M" if rng.rand() < 0.5 else "F",
                        age_table[rng.randint(len(age_table))],
                        rng.randint(_N_JOBS))
            for i in range(1, _N_USERS + 1)
        }
        _MOVIES = {}
        for i in range(1, _N_MOVIES + 1):
            cats = [_CATEGORIES[c] for c in rng.choice(
                len(_CATEGORIES), rng.randint(1, 4), replace=False)]
            title = " ".join("t%d" % w for w in rng.randint(
                _TITLE_WORDS, size=rng.randint(1, 5)))
            _MOVIES[i] = MovieInfo(i, cats, title)
        _FACTORS = (rng.randn(_N_USERS + 1, _DIM) * 0.6,
                    rng.randn(_N_MOVIES + 1, _DIM) * 0.6)
    return _USERS, _MOVIES, _FACTORS


def _reader(n, seed):
    def reader():
        users, movies, (uf, mf) = _meta()
        rng = np.random.RandomState(seed)
        for _ in range(n):
            u = int(rng.randint(1, _N_USERS + 1))
            m = int(rng.randint(1, _N_MOVIES + 1))
            score = float(np.clip(
                3.0 + uf[u] @ mf[m] + 0.3 * rng.randn(), 1.0, 5.0))
            yield users[u].value() + movies[m].value() + [[score]]

    return reader


def train():
    return _reader(8192, seed=31)


def test():
    return _reader(1024, seed=37)


def get_movie_title_dict():
    return _title_dict()


def movie_categories():
    return {c: i for i, c in enumerate(_CATEGORIES)}


def max_movie_id():
    return _N_MOVIES


def max_user_id():
    return _N_USERS


def max_job_id():
    return _N_JOBS - 1


def user_info():
    return dict(_meta()[0])


def movie_info():
    return dict(_meta()[1])
