"""HDFS helpers: a `hadoop fs` CLI wrapper + parallel transfer.

Reference: python/paddle/fluid/contrib/utils/hdfs_utils.py (HDFSClient
driving the hadoop binary via subprocess, with multi_download /
multi_upload fan-out). Same surface here; transfers fan out over a
thread pool (the work is subprocess-bound, so processes buy nothing).
"""

from __future__ import annotations

import logging
import os
import subprocess
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Optional, Tuple

__all__ = ["HDFSClient", "multi_download", "multi_upload"]

_logger = logging.getLogger(__name__)


class HDFSClient:
    """Thin driver around ``$hadoop_home/bin/hadoop fs`` (reference
    HDFSClient:35). ``configs`` become ``-D key=value`` pairs (e.g.
    fs.default.name, hadoop.job.ugi)."""

    def __init__(self, hadoop_home: str, configs: Optional[Dict] = None):
        self.hadoop_home = hadoop_home
        self.pre_commands: List[str] = [
            os.path.join(hadoop_home, "bin", "hadoop"), "fs"]
        for k, v in (configs or {}).items():
            self.pre_commands.append("-D%s=%s" % (k, v))

    def __run_hdfs_cmd(self, commands: List[str],
                       retry_times: int = 5) -> Tuple[int, str, str]:
        cmd = self.pre_commands + commands
        ret, out, err = 1, "", ""
        attempts = max(retry_times, 1)
        for attempt in range(attempts):
            proc = subprocess.run(cmd, stdout=subprocess.PIPE,
                                  stderr=subprocess.PIPE, text=True)
            ret, out, err = proc.returncode, proc.stdout, proc.stderr
            if ret == 0:
                break
            _logger.warning("hdfs cmd %s failed (attempt %d): %s",
                            commands[:1], attempt + 1, err.strip()[:200])
            if attempt + 1 < attempts:  # no pointless sleep after the last
                time.sleep(min(2 ** attempt, 8))
        return ret, out, err

    # ------------------------------------------------------------ queries
    def is_exist(self, hdfs_path: str) -> bool:
        ret, _, _ = self.__run_hdfs_cmd(["-test", "-e", hdfs_path],
                                        retry_times=1)
        return ret == 0

    def is_dir(self, hdfs_path: str) -> bool:
        ret, _, _ = self.__run_hdfs_cmd(["-test", "-d", hdfs_path],
                                        retry_times=1)
        return ret == 0

    def ls(self, hdfs_path: str) -> List[str]:
        ret, out, err = self.__run_hdfs_cmd(["-ls", hdfs_path], retry_times=1)
        if ret != 0:
            # an unreachable cluster / bad path must not look like an
            # empty directory (silent zero-file multi_download)
            raise IOError("hdfs ls %s failed (rc=%d): %s"
                          % (hdfs_path, ret, err.strip()[:200]))
        files = []
        for line in out.splitlines():
            parts = line.split(None, 7)  # 8th field keeps spaces in names
            if len(parts) >= 8:
                files.append(parts[7])
        return sorted(files)

    def lsr(self, hdfs_path: str, only_file: bool = True,
            sort: bool = True) -> List[str]:
        ret, out, err = self.__run_hdfs_cmd(["-lsr", hdfs_path],
                                            retry_times=1)
        if ret != 0:
            raise IOError("hdfs lsr %s failed (rc=%d): %s"
                          % (hdfs_path, ret, err.strip()[:200]))
        files = []
        for line in out.splitlines():
            parts = line.split(None, 7)
            if len(parts) >= 8:
                if only_file and parts[0].startswith("d"):
                    continue
                files.append(parts[7])
        return sorted(files) if sort else files

    # ------------------------------------------------------------ mutation
    def upload(self, hdfs_path: str, local_path: str,
               overwrite: bool = False, retry_times: int = 5) -> bool:
        if self.is_exist(hdfs_path):
            if not overwrite:
                # deterministic failure: don't burn the retry backoff
                _logger.warning("upload: %s exists and overwrite=False",
                                hdfs_path)
                return False
            self.delete(hdfs_path)
        ret, _, _ = self.__run_hdfs_cmd(["-put", local_path, hdfs_path],
                                        retry_times)
        return ret == 0

    def download(self, hdfs_path: str, local_path: str,
                 overwrite: bool = False, unzip: bool = False) -> bool:
        if os.path.exists(local_path):
            if not overwrite:
                _logger.warning("download: %s exists and overwrite=False",
                                local_path)
                return False
            if os.path.isdir(local_path):
                import shutil

                shutil.rmtree(local_path)
            else:
                os.remove(local_path)
        ret, _, _ = self.__run_hdfs_cmd(["-get", hdfs_path, local_path])
        if ret != 0:
            return False
        if unzip and os.path.isfile(local_path):
            import zipfile

            with zipfile.ZipFile(local_path) as z:
                z.extractall(os.path.dirname(local_path) or ".")
        return True

    def delete(self, hdfs_path: str) -> bool:
        flag = "-rmr" if self.is_dir(hdfs_path) else "-rm"
        ret, _, _ = self.__run_hdfs_cmd([flag, hdfs_path], retry_times=1)
        return ret == 0

    def rename(self, hdfs_src_path: str, hdfs_dst_path: str,
               overwrite: bool = False) -> bool:
        if overwrite and self.is_exist(hdfs_dst_path):
            self.delete(hdfs_dst_path)
        ret, _, _ = self.__run_hdfs_cmd(["-mv", hdfs_src_path, hdfs_dst_path],
                                        retry_times=1)
        return ret == 0

    def makedirs(self, hdfs_path: str) -> bool:
        ret, _, _ = self.__run_hdfs_cmd(["-mkdir", "-p", hdfs_path])
        return ret == 0

    @staticmethod
    def make_local_dirs(local_path: str) -> None:
        os.makedirs(local_path, exist_ok=True)


def _fan_out(fn, items, trainers, trainer_id, multi_processes):
    mine = [it for i, it in enumerate(sorted(items))
            if i % max(trainers, 1) == trainer_id]
    if not mine:
        return []
    with ThreadPoolExecutor(max_workers=max(multi_processes, 1)) as pool:
        return list(pool.map(fn, mine))


def multi_download(client: HDFSClient, hdfs_path: str, local_path: str,
                   trainer_id: int, trainers: int,
                   multi_processes: int = 5) -> List[str]:
    """Round-robin this trainer's share of hdfs_path's files and fetch
    them in parallel (reference multi_download:437). Returns the local
    paths downloaded."""
    client.make_local_dirs(local_path)
    files = client.lsr(hdfs_path, only_file=True)
    prefix = hdfs_path.rstrip("/")

    def _get(f):
        if f == prefix or f.startswith(prefix + "/"):
            rel = f[len(prefix):].lstrip("/") or os.path.basename(f)
        else:
            # path printed in a different form (scheme stripped, etc.):
            # keep the full remote structure so distinct files can't
            # collide on a shared basename
            rel = f.lstrip("/")
        dst = os.path.join(local_path, rel)
        HDFSClient.make_local_dirs(os.path.dirname(dst) or ".")
        return dst if client.download(f, dst, overwrite=True) else None

    got = _fan_out(_get, files, trainers, trainer_id, multi_processes)
    failed = sum(1 for g in got if g is None)
    if failed:
        _logger.warning("multi_download: %d/%d files failed", failed,
                        len(got))
    return [g for g in got if g is not None]


def multi_upload(client: HDFSClient, hdfs_path: str, local_path: str,
                 multi_processes: int = 5, overwrite: bool = False) -> int:
    """Upload every file under local_path in parallel (reference
    multi_upload:503). Returns the number of files uploaded."""
    todo = []
    for root, _dirs, files in os.walk(local_path):
        for f in files:
            todo.append(os.path.join(root, f))
    client.makedirs(hdfs_path)

    def _put(f):
        rel = os.path.relpath(f, local_path)
        dst = "/".join([hdfs_path.rstrip("/")] + rel.split(os.sep))
        parent = dst.rsplit("/", 1)[0]
        client.makedirs(parent)
        return client.upload(dst, f, overwrite=overwrite)

    return sum(bool(r) for r in
               _fan_out(_put, todo, 1, 0, multi_processes))
