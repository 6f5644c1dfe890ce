"""File and path helpers, the counterparts of the JAX package's
`utils/files.py:19-87`: a context-managed working directory, a space-free
stand-in for a path, a file's age, date and size, and the newest `last`
checkpoint under a directory. `increment_path` is `utils/settings.py`'s,
re-exported here as JAX re-exports its own."""
from __future__ import annotations

import contextlib
import glob
import os
import shutil
from datetime import datetime
from pathlib import Path

from .settings import increment_path  # noqa: F401  (re-export, as JAX's)


class WorkingDirectory(contextlib.ContextDecorator):
    """`@WorkingDirectory(dir)` or `with WorkingDirectory(dir):` runs in
    `dir` and returns to the directory it started from."""

    def __init__(self, new_dir):
        self.dir = new_dir
        self.cwd = Path.cwd().resolve()

    def __enter__(self):
        os.chdir(self.dir)

    def __exit__(self, exc_type, exc_val, exc_tb):
        os.chdir(self.cwd)


@contextlib.contextmanager
def spaces_in_path(path):
    """Yield `path` where it has no space, else a copy of it with the
    spaces of its name made underscores, copied back over `path` on exit."""
    if " " not in str(path):
        yield path
        return
    p = Path(path)
    tmp = p.with_name(p.name.replace(" ", "_"))
    if p.is_dir():
        shutil.copytree(p, tmp, dirs_exist_ok=True)
    elif p.is_file():
        shutil.copy2(p, tmp)
    try:
        yield tmp
    finally:
        if tmp.is_dir():
            shutil.copytree(tmp, p, dirs_exist_ok=True)
            shutil.rmtree(tmp)
        elif tmp.is_file():
            shutil.copy2(tmp, p)
            tmp.unlink()


def file_age(path) -> int:
    """Whole days since the last modification."""
    return (datetime.now() - datetime.fromtimestamp(Path(path).stat().st_mtime)).days


def file_date(path) -> str:
    """'YYYY-M-D' of the last modification."""
    t = datetime.fromtimestamp(Path(path).stat().st_mtime)
    return f"{t.year}-{t.month}-{t.day}"


def file_size(path) -> float:
    """Size in MB of a file, or of every file under a directory; 0 where
    neither."""
    p = Path(path)
    mb = 1 << 20
    if p.is_file():
        return p.stat().st_size / mb
    if p.is_dir():
        return sum(f.stat().st_size for f in p.glob("**/*") if f.is_file()) / mb
    return 0.0


def get_latest_run(search_dir: str = ".") -> str:
    """The most recently modified `last` checkpoint under `search_dir`: the
    port's `last*.npz` (not a `_resume` state) and the files JAX's looks
    for (`last*.ckpt*`, `last*.pt`, `last*.msgpack`); where there is none,
    any `last*` path; "" where nothing matches."""
    last = [p for p in glob.glob(f"{search_dir}/**/last*.npz", recursive=True)
            if not p.endswith("_resume.npz")]
    for pattern in ("last*.ckpt*", "last*.pt", "last*.msgpack"):
        last += glob.glob(f"{search_dir}/**/{pattern}", recursive=True)
    cands = last or [d for d in glob.glob(f"{search_dir}/**/last*", recursive=True)
                     if Path(d).exists()]
    return max(cands, key=os.path.getmtime) if cands else ""
