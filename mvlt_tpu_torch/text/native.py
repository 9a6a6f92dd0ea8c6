"""ctypes bindings of the port's native C++ tokenizers (a copy of
``mvlt_tpu/text/native.py``): the WordPiece tokenizer
(``mvlt_tpu_torch/csrc/host/tokenizer.cc``) and the PTB tokenizer of the
metric path (``csrc/host/ptb.cc``), both copies of the JAX package's
sources.

The library is built at first use with the host C++ compiler (``$CXX``,
else ``c++``; ``-O2 -std=c++17 -shared -fPIC``) into
``build/host/libmvlt_native-<digest>.so`` beside the package, the digest
taken over the sources and the flags. The build writes a temporary file
and renames it, under a file lock, so that processes that start at once
(test workers, a driver's ranks) build it once. A failed build raises.

:class:`NativeWordPiece` is the fast path of ``WordPieceTokenizer.encode``
on ASCII text; the tokenizer falls back to pure Python for non-ASCII input
and for text past the 4,096-id buffer, as JAX's does (those are
semantics: the C++ code handles ASCII only). :func:`ptb_tokenize_native`
returns None in the same two cases.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import pathlib
import shutil
import subprocess
import tempfile
import threading
from typing import List, Optional

_SRC = pathlib.Path(__file__).resolve().parents[1] / "csrc" / "host"
SOURCES = ("tokenizer.cc", "ptb.cc")
CXX_FLAGS = ("-O2", "-std=c++17", "-shared", "-fPIC")
BUILD_DIR = pathlib.Path(__file__).resolve().parents[2] / "build" / "host"
# ids one native encode call can return (JAX's buffer)
MAX_IDS = 4096

_lib: Optional[ctypes.CDLL] = None
_lock = threading.Lock()


def _compiler() -> str:
    cxx = os.environ.get("CXX") or shutil.which("c++") or shutil.which("g++")
    if not cxx:
        raise RuntimeError("no host C++ compiler ($CXX, c++ or g++) to build "
                           "the native tokenizers")
    return cxx


def library_path(directory=None) -> pathlib.Path:
    """Where the library built from this checkout's sources lies, in
    ``directory`` (default :data:`BUILD_DIR`)."""
    digest = hashlib.sha1(b"".join((_SRC / s).read_bytes() for s in SOURCES)
                          + " ".join(CXX_FLAGS).encode()).hexdigest()[:12]
    return pathlib.Path(directory or BUILD_DIR) / f"libmvlt_native-{digest}.so"


def build(directory=None) -> pathlib.Path:
    """Compile the library into ``directory`` (default :data:`BUILD_DIR`)
    unless it is there; returns its path. Raises ``RuntimeError`` with the
    compiler's output if the build fails."""
    target = library_path(directory)
    if target.exists():
        return target
    out = target.parent
    out.mkdir(parents=True, exist_ok=True)
    with open(out / ".lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if target.exists():             # built while this one waited
            return target
        fd, tmp = tempfile.mkstemp(dir=out, suffix=".so.tmp")
        os.close(fd)
        try:
            cmd = [_compiler(), *CXX_FLAGS, "-o", tmp,
                   *(str(_SRC / s) for s in SOURCES)]
            proc = subprocess.run(cmd, capture_output=True, text=True)
            if proc.returncode != 0:
                raise RuntimeError("native tokenizer build failed ("
                                   f"{' '.join(cmd)}):\n{proc.stderr}")
            os.replace(tmp, target)
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)
    return target


def load_library() -> ctypes.CDLL:
    """The library, built at first use and loaded once a process."""
    global _lib
    if _lib is not None:
        return _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            lib.mvlt_tokenizer_create.restype = ctypes.c_void_p
            lib.mvlt_tokenizer_create.argtypes = [ctypes.c_char_p,
                                                  ctypes.c_int]
            lib.mvlt_tokenizer_add_token.restype = ctypes.c_int
            lib.mvlt_tokenizer_add_token.argtypes = [ctypes.c_void_p,
                                                     ctypes.c_char_p]
            lib.mvlt_tokenizer_vocab_size.restype = ctypes.c_int
            lib.mvlt_tokenizer_vocab_size.argtypes = [ctypes.c_void_p]
            lib.mvlt_tokenizer_destroy.argtypes = [ctypes.c_void_p]
            lib.mvlt_tokenizer_encode.restype = ctypes.c_int
            lib.mvlt_tokenizer_encode.argtypes = [
                ctypes.c_void_p, ctypes.c_char_p,
                ctypes.POINTER(ctypes.c_int), ctypes.c_int]
            lib.mvlt_ptb_tokenize.restype = ctypes.c_int
            lib.mvlt_ptb_tokenize.argtypes = [ctypes.c_char_p,
                                              ctypes.c_char_p, ctypes.c_int]
            _lib = lib
    return _lib


def ptb_tokenize_native(text: str) -> Optional[str]:
    """Native PTB tokenization (``csrc/host/ptb.cc``); None for non-ASCII
    input or an output past its buffer (the caller then runs the Python
    tokenizer)."""
    if not text.isascii():
        return None
    lib = load_library()
    # worst case ~7x: every '(' expands to ' -LRB- '
    buf = ctypes.create_string_buffer(max(4096, len(text) * 8 + 16))
    n = lib.mvlt_ptb_tokenize(text.encode(), buf, len(buf))
    if n < 0:
        return None
    return buf.value.decode()


class NativeWordPiece:
    """WordPiece encoding in C++ on ``vocab_path`` plus ``eos_token``."""

    def __init__(self, vocab_path: str, do_lower_case: bool = True,
                 eos_token: str = "[END]"):
        self.lib = load_library()
        self.handle = self.lib.mvlt_tokenizer_create(
            vocab_path.encode(), int(do_lower_case))
        if not self.handle:
            raise FileNotFoundError(vocab_path)
        self.lib.mvlt_tokenizer_add_token(self.handle, eos_token.encode())
        self._buf = (ctypes.c_int * MAX_IDS)()

    def __del__(self):
        if getattr(self, "handle", None) and getattr(self, "lib", None):
            self.lib.mvlt_tokenizer_destroy(self.handle)
            self.handle = None

    def vocab_size(self) -> int:
        return self.lib.mvlt_tokenizer_vocab_size(self.handle)

    def encode(self, text: str) -> List[int]:
        """The ids of ``text``; ``ValueError`` past :data:`MAX_IDS`."""
        n = self.lib.mvlt_tokenizer_encode(
            self.handle, text.encode(), self._buf, len(self._buf))
        if n < 0:
            raise ValueError("text too long for native buffer")
        return list(self._buf[:n])
