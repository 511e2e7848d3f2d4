"""Version metadata (reference python/paddle/version.py, generated by
setup.py.in:61 — here a plain module; the API shape is what user code
imports: full_version/major/minor/patch/commit + show())."""

import subprocess

major = 1
minor = 3
patch = "0-tpu"
rc = 0
full_version = "%d.%d.%s" % (major, minor, patch)
istaged = False
with_gpu = "ON"  # the compute backend is CUDA
with_tpu = "OFF"


_commit_cache = None


def _git_commit() -> str:
    global _commit_cache
    if _commit_cache is None:
        try:
            out = subprocess.run(
                ["git", "rev-parse", "HEAD"], capture_output=True, text=True,
                timeout=5,
                cwd=__file__.rsplit("/", 2)[0])
            _commit_cache = out.stdout.strip()[:12] or "unknown"
        except Exception:
            _commit_cache = "unknown"
    return _commit_cache


def __getattr__(name):
    # `commit` is resolved lazily: shelling out to git at import time adds
    # a subprocess spawn (up to its 5s timeout) to every `import paddle_tpu_torch`,
    # including the embedded-interpreter paths (serving.cc / train.cc).
    if name == "commit":
        return _git_commit()
    raise AttributeError(name)


def show() -> None:
    print("full_version:", full_version)
    print("major:", major)
    print("minor:", minor)
    print("patch:", patch)
    print("commit:", _git_commit())
    print("with_tpu:", with_tpu)
