"""Pre-pivoting panel kernel for Hopper: CUDA called through the XLA FFI.

The low-precision panel LU picks the pivots of every r-wide panel (the
reference's `HGETF2_kernel`, `hgetf2_kernel.cu:15-120`).  Its plain version,
:func:`mpf_tpu.ops.getf2.panel_pivots_perm`, runs one XLA loop step per
column, each a handful of launches over the whole (m, r) panel.  The kernel
in `native/panel_pivots.cu` runs the whole panel in one persistent
cooperative launch that keeps the panel in the SMs' shared memory and pays
two grid barriers per column.  It returns the same pivots and row map.

The library is built for sm_90a from `native/panel_pivots.cu` into
`native/build/` (`make -C native cuda`) the first time a Hopper GPU selects
the kernel; the build needs `nvcc` and the `jax.ffi` headers.  A build or
launch that fails raises.

:func:`panel_kernel` chooses between the kernel and the plain version by
device and shape: the kernel on a GPU of compute capability 9.0 where the
library says the panel fits, the plain version on every other device.
The library sizes the launch for both the selection and the launch.
"""

from __future__ import annotations

import ctypes
import functools
import shutil
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp

from mpf_tpu.ops.getf2 import panel_pivots_perm

_NATIVE = Path(__file__).resolve().parents[2] / "native"
_LIB = _NATIVE / "build" / "libmpf_cuda.so"
_TARGET = "mpf_panel_pivots"

_DTYPES = (jnp.dtype(jnp.bfloat16), jnp.dtype(jnp.float16), jnp.dtype(jnp.float32))

#: The compute capability the library is built for (sm_90a: Hopper only).
CAPABILITY = "9.0"


def build() -> Path:
    """Build the CUDA library (incremental) and return its path."""
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    res = subprocess.run(
        ["make", "-C", str(_NATIVE), "cuda", f"NVCC={nvcc}", f"PYTHON={sys.executable}",
         f"JAX_FFI_INCLUDE={jax.ffi.include_dir()}"],
        capture_output=True, text=True,
    )
    if res.returncode:
        raise RuntimeError(f"building {_LIB} failed:\n{res.stdout}{res.stderr}")
    return _LIB


@functools.cache
def _register() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build()))
    lib.MpfPanelFits.argtypes = (ctypes.c_int,) * 3
    lib.MpfPanelFits.restype = ctypes.c_int
    lib.MpfPanelScratchBytes.argtypes = (ctypes.c_int,)
    lib.MpfPanelScratchBytes.restype = ctypes.c_longlong
    jax.ffi.register_ffi_target(
        _TARGET, jax.ffi.pycapsule(lib.MpfPanelPivots), platform="CUDA")
    return lib


def fits(m: int, r: int, dtype) -> bool:
    """Whether an (m, r) panel of ``dtype`` fits the kernel on the current
    CUDA device: a supported dtype, and the rows each block keeps within
    the shared memory one block may opt in to.  The library sizes the
    launch and answers, so selection and launch use one computation."""
    dtype = jnp.dtype(dtype)
    if dtype not in _DTYPES:
        return False
    ans = _register().MpfPanelFits(m, r, dtype.itemsize)
    if ans < 0:
        raise RuntimeError("mpf panel kernel: cannot query the CUDA device")
    return ans == 1


def panel_pivots_cuda(panel: jax.Array, row_offset=0, prev_perm=None):
    """Drop-in for :func:`panel_pivots_perm` (without ``ncols``): returns
    ``(piv, perm)``, or ``(piv, perm, prev_perm[perm])`` given
    ``prev_perm``."""
    m, r = panel.shape
    scratch = _register().MpfPanelScratchBytes(r)
    off = jnp.asarray(row_offset, jnp.int32).reshape(())
    piv, perm, _ = jax.ffi.ffi_call(
        _TARGET,
        (jax.ShapeDtypeStruct((r,), jnp.int32),
         jax.ShapeDtypeStruct((m,), jnp.int32),
         jax.ShapeDtypeStruct((scratch,), jnp.uint8)),
    )(panel, off)
    if prev_perm is not None:
        return piv, perm, jnp.take(prev_perm, perm)
    return piv, perm


def panel_kernel(m: int, r: int, dtype, device=None):
    """The pivot panel for an (m, r) panel of ``dtype`` on ``device``
    (default: JAX's first device): the CUDA kernel on a Hopper GPU (compute
    capability :data:`CAPABILITY`) where the panel fits it,
    :func:`panel_pivots_perm` elsewhere."""
    device = jax.devices()[0] if device is None else device
    if (device.platform != "gpu"
            or getattr(device, "compute_capability", None) != CAPABILITY):
        return panel_pivots_perm
    return panel_pivots_cuda if fits(m, r, dtype) else panel_pivots_perm
