"""Build the native tokenizer libraries (WordPiece, byte-level BPE and the
vocabulary trainer's merge engine) with the host's C++ compiler.

    python -m bert_pytorch_tpu_torch.native.build [--force]

Each library is built at first use (bert_pytorch_tpu_torch.native loads
them) into `_build/` beside this file, named by the sha256 of its source
and unicode_tables.h, so an edited source builds anew and a stale library
is never loaded. The compiler writes a name of its own (process and
thread) and `os.replace` puts the library in place, so processes that
build at once (pytest-xdist workers, a server's spawned featurizers)
leave one whole library; a lock serializes the threads of one process.
The libraries expose a plain C ABI, loaded with ctypes. A failed build
raises with the compiler's stderr.
"""

from __future__ import annotations

import hashlib
import os
import shutil
import subprocess
import sys
import threading

HERE = os.path.dirname(os.path.abspath(__file__))
BUILD_DIR = os.path.join(HERE, "_build")
HEADER = os.path.join(HERE, "unicode_tables.h")
TARGETS = {"wordpiece": "wordpiece.cc", "bpe": "bpe.cc",
           "vocab_trainer": "vocab_trainer.cc"}
FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC", "-pthread")

_lock = threading.Lock()


class NativeBuildError(RuntimeError):
    """The C++ compiler is missing or refused a source."""


def source_digest(target: str) -> str:
    h = hashlib.sha256()
    for path in (os.path.join(HERE, TARGETS[target]), HEADER):
        with open(path, "rb") as f:
            h.update(f.read())
    return h.hexdigest()


def library_path(target: str) -> str:
    return os.path.join(BUILD_DIR,
                        f"_{target}.{source_digest(target)[:16]}.so")


def build(target: str, force: bool = False) -> str:
    """The path of `target`'s library, compiled first unless a library of
    the current sources is there (or `force`)."""
    with _lock:
        path = library_path(target)
        if os.path.exists(path) and not force:
            return path
        cxx = os.environ.get("CXX") or shutil.which("g++") \
            or shutil.which("c++")
        if not cxx:
            raise NativeBuildError(
                "no C++ compiler found (set CXX or install g++)")
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = f"{path}.{os.getpid()}.{threading.get_ident()}.tmp"
        cmd = [cxx, *FLAGS, os.path.join(HERE, TARGETS[target]), "-o", tmp]
        try:
            proc = subprocess.run(cmd, capture_output=True, text=True,
                                  timeout=600)
        except OSError as e:
            raise NativeBuildError(
                f"native build failed ({' '.join(cmd)}): {e}") from e
        if proc.returncode != 0:
            if os.path.exists(tmp):
                os.remove(tmp)
            raise NativeBuildError(
                f"native build failed ({' '.join(cmd)}), exit "
                f"{proc.returncode}:\n{proc.stderr[-4000:]}")
        os.replace(tmp, path)
        return path


if __name__ == "__main__":
    for name in TARGETS:
        print(build(name, force="--force" in sys.argv))
