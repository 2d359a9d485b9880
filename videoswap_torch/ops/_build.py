"""Build and load the port's CUDA kernels.

The kernels live in `videoswap_torch/csrc/*.cu` with a plain C interface.
At first use each source is compiled with `nvcc` for `sm_90a` into an
object file, all sources at once in parallel processes, and the objects are
linked into one shared library under `build/videoswap_torch_kernels/` at the
repository root, loaded with `ctypes`. The library's file name carries a digest of the
sources and flags, so an edited source is rebuilt and an unchanged one is
reused. Nothing here runs at import time: the CPU tests import every module
of the port on a machine without `nvcc`.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / 'csrc'
BUILD_DIR = (Path(__file__).resolve().parents[2] / 'build'
             / 'videoswap_torch_kernels')
NVCC_FLAGS = ('-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17', '-O3',
              '-Xcompiler', '-fPIC', '-Xptxas', '-v')

_P = ctypes.c_void_p
_I = ctypes.c_int
_STRIDES = ctypes.POINTER(ctypes.c_longlong)
# C entry point -> argument types; every entry point returns a cudaError_t,
# but those in _RESTYPES
_SIGNATURES = {
    'vs_geglu_ffn': [_P, _P, _P, _P, _P, _P, _I, _I, _P],
    'vs_geglu_gate': [_P, _P, _I, _I, _P],
    'vs_temporal_attention': [_P, _P, _P, _P, _I, _I, _I, _I, _P],
    'vs_temporal_attention_plan': [_I, _I, _I, ctypes.POINTER(_I)],
    'vs_flash_attention_fwd': [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                               _STRIDES, _P],
    'vs_flash_attention_bwd_dq': [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                                  _I, _STRIDES, _P],
    'vs_flash_attention_bwd_dkv': [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I,
                                   _I, _I, _I, _STRIDES, _P],
    'vs_hash_table_grad_levels': [_P, _P, _P, _P, ctypes.POINTER(_I), _I, _I,
                                  ctypes.c_longlong, _I, _I, _P],
    'vs_hash_table_grad_table_words': [ctypes.POINTER(_I), _I, _I],
    'vs_fused_temporal': [ctypes.POINTER(_P), _I, _I, _I, _I, _I, _I,
                          ctypes.c_longlong, _I, ctypes.c_float, _P],
    'vs_spatial_attention': [_P, _P, _P, _P, _I, _I, _I, _I, _I, _STRIDES,
                             _P],
    'vs_gn_silu_conv': [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
    'vs_gn_silu_conv_plan': [_I, _I, ctypes.POINTER(_I)],
}
_RESTYPES = {'vs_hash_table_grad_table_words': ctypes.c_longlong}


class KernelBuildError(RuntimeError):
    pass


def _nvcc() -> str:
    found = shutil.which('nvcc')
    if found:
        return found
    for root in (os.environ.get('CUDA_HOME'), '/usr/local/cuda'):
        if root and Path(root, 'bin', 'nvcc').exists():
            return str(Path(root, 'bin', 'nvcc'))
    raise KernelBuildError('nvcc not found: the CUDA kernels are built on a '
                           'machine with the CUDA toolkit')


def _sources() -> list[Path]:
    return sorted(CSRC.glob('*.cu'))


def _digest() -> str:
    h = hashlib.sha256(' '.join(NVCC_FLAGS).encode())
    for p in sorted(CSRC.glob('*.cu*')):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def build() -> tuple[Path, float]:
    """Compile the kernels if the library for these sources is missing.
    Returns (library path, seconds spent compiling; 0.0 when reused)."""
    out = BUILD_DIR / f'libvideoswap_kernels_{_digest()}.so'
    if out.exists():
        return out, 0.0
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = f'{out.stem}.{os.getpid()}'
    nvcc = _nvcc()
    t0 = time.perf_counter()
    objs, procs = [], []
    for src in _sources():
        obj = BUILD_DIR / f'{tag}.{src.stem}.o'
        objs.append(obj)
        procs.append(subprocess.Popen(
            [nvcc, *NVCC_FLAGS, '-c', '-o', str(obj), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    logs = [(p.communicate()[0], p.returncode) for p in procs]
    text = ''.join(f'== {src.name}\n{log}' for src, (log, _)
                   in zip(_sources(), logs))
    failed = [rc for _, rc in logs if rc]
    tmp = out.with_name(f'{tag}.tmp')
    if not failed:
        link = subprocess.run([nvcc, '-shared', '-o', str(tmp),
                               *map(str, objs)], capture_output=True,
                              text=True)
        text += link.stdout + link.stderr
        failed = [link.returncode] if link.returncode else []
    seconds = time.perf_counter() - t0
    for obj in objs:
        obj.unlink(missing_ok=True)
    out.with_suffix('.log').write_text(text)
    if failed:
        raise KernelBuildError(f'nvcc failed ({failed}):\n{text[-8000:]}')
    # atomic: a concurrent process never sees a partial file
    os.replace(tmp, out)
    return out, seconds


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    path, _ = build()
    lib = ctypes.CDLL(str(path))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = _RESTYPES.get(name, ctypes.c_int)
    return lib


def check(status: int, name: str) -> None:
    """Raise on a non-zero cudaError_t returned by a launch."""
    if status != 0:
        raise RuntimeError(f'{name}: CUDA launch failed with cudaError_t '
                           f'{status}')
