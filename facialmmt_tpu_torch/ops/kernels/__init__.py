"""Hand-written Hopper kernels and their build.

The CUDA C++ sources under ``facialmmt_tpu_torch/csrc/`` compile with nvcc
into ONE shared library with a plain C interface, bound with ctypes.  Every
source is compiled by its own nvcc process, all started together, and the
objects are linked once:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 \
         -Xcompiler -fPIC -c csrc/<name>.cu -o _build/<hash>_<name>.o
    nvcc -shared -o _build/libfmmt_kernels_<hash>.so _build/<hash>_*.o

The build runs at first use of a kernel on a CUDA tensor and is cached by a
hash of the sources in ``facialmmt_tpu_torch/_build/``; nothing is built when
the package is imported, and nothing on the CPU path needs nvcc.

Each kernel module (attention, fused_block, block_mlp, window_attention,
merge_kernel, shift_permute) holds the plain PyTorch versions, the kernel
wrappers with their launch counters, and the dispatch: a CPU tensor takes the
plain version, a CUDA tensor the kernel, which raises on anything it cannot
take.  The Swin block halves are torch.autograd.Functions whose backward
follows the same rule; the text-tower attention (`attention.fused_attention`),
the window-attention cores, the merge tail and the whole block
(`fused_block.fused_whole_block`) are Functions whose backward differentiates
their plain version (`grads_of_recomputed`), as the JAX package has no
backward kernel for them; `shift_permute`'s backward is the same
kernel in the opposite direction, and its launches count under
`shift_permute` too.  The whole block and the shift permutation are, as in
the JAX package, called by no module of the model.  `add_layernorm` (the
residual add and TF-style LayerNorm of the text tower and the fusion stacks)
has no TPU counterpart: LayerNormTF takes its kernel at inference on the
card and its plain version under grad, which autograd differentiates.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

PACKAGE_DIR = Path(__file__).resolve().parents[2]
SRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v"]


def _sources() -> list[Path]:
    return sorted(SRC_DIR.glob("*.cu")) + sorted(SRC_DIR.glob("*.cuh"))


def _nvcc() -> str:
    for cand in (os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc"), shutil.which("nvcc")):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH); "
                       "the CUDA kernels are built from csrc/ at first use")


def library_path() -> Path:
    digest = hashlib.sha256()
    for src in _sources():
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    return BUILD_DIR / f"libfmmt_kernels_{digest.hexdigest()[:16]}.so"


def build() -> tuple[Path, float]:
    """Compile csrc/*.cu into the shared library unless a build of the same
    sources exists.  Returns (path, seconds spent compiling).  The compiler's
    output, with ptxas's register and shared-memory report, is kept next to
    the library as build.log."""
    path = library_path()
    if path.exists():
        return path, 0.0
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    tag = f"{path.stem}.{os.getpid()}"
    sources = sorted(SRC_DIR.glob("*.cu"))
    objects = [BUILD_DIR / f"{tag}_{src.stem}.o" for src in sources]

    def run(cmd):
        proc = subprocess.run(cmd, capture_output=True, text=True)
        return " ".join(cmd) + "\n" + proc.stdout + proc.stderr, proc.returncode

    t0 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=len(sources)) as pool:
        results = list(pool.map(
            lambda so: run([nvcc, *NVCC_FLAGS, "-c", str(so[0]), "-o",
                            str(so[1])]), zip(sources, objects)))
    tmp = path.with_suffix(f".{os.getpid()}.tmp")
    if all(rc == 0 for _, rc in results):
        results.append(run([nvcc, "-shared", "-o", str(tmp),
                            *[str(o) for o in objects]]))
    seconds = time.perf_counter() - t0
    (BUILD_DIR / "build.log").write_text("".join(out for out, _ in results))
    for obj in objects:
        obj.unlink(missing_ok=True)
    failed = [out for out, rc in results if rc != 0]
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    os.replace(tmp, path)
    return path, seconds


_VP, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {
    "fmmt_fused_attention": ([_VP] * 5 + [_I] * 6 + [_VP], _I),
    "fmmt_fused_attention_block": ([_VP] * 13 + [_I] * 6 + [_F, _VP], _I),
    "fmmt_fused_attention_block_smem": ([_I] * 3, ctypes.c_longlong),
    "fmmt_fused_ln_mlp_residual": ([_VP] * 12 + [_I] * 4 + [_F, _VP], _I),
    "fmmt_fused_ln_mlp_residual_smem": ([_I] * 2, ctypes.c_longlong),
    "fmmt_fused_ln_mlp_residual_bwd": ([_VP] * 15 + [_I] * 4 + [_F, _VP], _I),
    "fmmt_fused_ln_mlp_residual_bwd_smem": ([_I] * 2, ctypes.c_longlong),
    "fmmt_fused_ln_mlp_residual_bwd_scratch": ([_I] * 3, ctypes.c_longlong),
    "fmmt_fused_attention_block_bwd": ([_VP] * 17 + [_I] * 6 + [_F, _VP], _I),
    "fmmt_fused_attention_block_bwd_smem": ([_I] * 2, ctypes.c_longlong),
    "fmmt_fused_attention_block_bwd_scratch": ([_I] * 5, ctypes.c_longlong),
    "fmmt_fused_attention_block_bwd_spill": ([_VP] * 17 + [_I] * 6 + [_F, _VP],
                                             _I),
    "fmmt_window_attention": ([_VP] * 5 + [_I] * 8 + [_VP], _I),
    "fmmt_window_attention_smem": ([_I] * 3, ctypes.c_longlong),
    "fmmt_fused_merge": ([_VP] * 7 + [_I] * 4 + [_F, _VP], _I),
    "fmmt_fused_merge_smem": ([_I], ctypes.c_longlong),
    "fmmt_fused_whole_block": ([_VP] * 16 + [_I] * 7 + [_F, _VP], _I),
    "fmmt_fused_whole_block_smem": ([_I] * 5, ctypes.c_longlong),
    "fmmt_fused_whole_block_scratch": ([_I] * 7, ctypes.c_longlong),
    "fmmt_shift_permute": ([_VP] * 2 + [_I] * 7 + [_VP], _I),
    "fmmt_add_layernorm": ([_VP] * 5 + [_I] * 4 + [_F, _VP], _I),
}


@functools.lru_cache(maxsize=1)
def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first call."""
    path, _ = build()
    lib = ctypes.CDLL(str(path))
    for name, (argtypes, restype) in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = restype
    return lib


def resolve_device(device) -> torch.device:
    """The device an entry point runs on.  Entry points default to the card;
    without one they raise rather than move to the CPU, which the caller must
    ask for by name."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is visible; pass device='cpu' to "
                           "run on the CPU")
    return dev


def to_device_async(host: torch.Tensor, device: torch.device) -> torch.Tensor:
    """A host tensor on `device` without the host waiting.  A blocking
    host-to-device copy synchronizes the stream, so the caller would wait for
    all the work queued before it (a serving pack's dispatch for the pack
    before it), and a copy from pageable memory is synchronous with respect
    to the host in any case: on the card the tensor is staged in page-locked
    memory first.  The caching host allocator hands the pinned block out
    again only once the copy from it has completed."""
    if device.type == "cuda":
        host = host.pin_memory()
    return host.to(device, non_blocking=True)


def check_launch(name: str, err: int) -> None:
    """Raise if a C entry point reported a CUDA error (its launch never ran)."""
    if err != 0:
        raise RuntimeError(f"{name}: launch failed with cudaError_t {err}")


def max_shared_memory(device: torch.device) -> int:
    """Opt-in shared memory per block on `device` (232448 bytes on Hopper)."""
    return int(torch.cuda.get_device_properties(device)
               .shared_memory_per_block_optin)


def stream_ptr(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(msg)


def check_cuda_tensor(name: str, t: torch.Tensor, dtype: torch.dtype,
                      shape: tuple, device: torch.device) -> None:
    """Kernel operands: on `device`, of `dtype` and `shape`, contiguous and
    32-byte aligned (the tensor-core tile loads need it)."""
    require(t.device == device, f"{name}: on {t.device}, expected {device}")
    require(t.dtype == dtype, f"{name}: dtype {t.dtype}, expected {dtype}")
    require(tuple(t.shape) == tuple(shape),
            f"{name}: shape {tuple(t.shape)}, expected {tuple(shape)}")
    require(t.is_contiguous(), f"{name}: must be contiguous")
    require(t.data_ptr() % 32 == 0, f"{name}: must be 32-byte aligned")


# The token types kernels 1-11 take (x, dy, dx, out; the attention cores'
# q, k, v, out): each C entry point has an instantiation of both, as the JAX
# kernels read x in its own dtype.  Their weights go to the kernels in bf16.
# Kernel 12 (shift_permute) copies rows of any dtype byte for byte.
TOKEN_DTYPES = (torch.bfloat16, torch.float32)


def check_token_dtype(name: str, t: torch.Tensor) -> None:
    require(t.dtype in TOKEN_DTYPES,
            f"{name}: dtype {t.dtype}; kernels 1-11 take {TOKEN_DTYPES}")


def token_operand(t: torch.Tensor) -> torch.Tensor:
    """x, dy (or the attention cores' q, k, v) as kernels 1-11 take them:
    detached and contiguous in their own dtype, bf16 or fp32.  Any other
    dtype raises: the kernels never see a quiet cast of the tokens."""
    check_token_dtype("tokens", t)
    return t.detach().contiguous()


def is_f32(t: torch.Tensor) -> int:
    """The C entry points' token-type argument: 1 for fp32, 0 for bf16."""
    return int(t.dtype == torch.float32)


def grads_of_recomputed(fn, inputs, needs_grad, dout):
    """Cotangents of fn(*inputs) under `dout`, one per input and None where
    `needs_grad` is false: torch autograd of `fn` recomputed from the saved
    inputs, outside autocast so that fp32 stays fp32."""
    leaves = [t.detach().requires_grad_(need)
              for t, need in zip(inputs, needs_grad)]
    with torch.enable_grad(), torch.autocast(dout.device.type, enabled=False):
        out = fn(*leaves)
        grads = iter(torch.autograd.grad(
            out, [t for t in leaves if t.requires_grad], dout.to(out.dtype)))
    return [next(grads) if t.requires_grad else None for t in leaves]


def kernel_wrappers():
    """name -> CUDA wrapper of every kernel of the port; each wrapper carries
    a `launches` count of the kernels it launched."""
    from facialmmt_tpu_torch.ops.kernels import (add_layernorm, attention,
                                                 block_mlp, fused_block,
                                                 merge_kernel, shift_permute,
                                                 window_attention)

    return {"fused_attention": attention.fused_attention_cuda,
            "fused_attention_block": fused_block.fused_attention_block_cuda,
            "fused_ln_mlp_residual": block_mlp.fused_ln_mlp_residual_cuda,
            "fused_ln_mlp_residual_bwd": block_mlp.fused_ln_mlp_residual_bwd_cuda,
            "fused_attention_block_bwd":
                fused_block.fused_attention_block_bwd_cuda,
            "fused_attention_block_bwd_spill":
                fused_block.fused_attention_block_bwd_spill_cuda,
            "fused_window_attention":
                window_attention.fused_window_attention_cuda,
            "paired_window_attention":
                window_attention.paired_window_attention_cuda,
            "fused_window_attention_v2":
                window_attention.fused_window_attention_v2_cuda,
            "fused_merge": merge_kernel.fused_merge_cuda,
            "fused_whole_block": fused_block.fused_whole_block_cuda,
            "shift_permute": shift_permute.shift_permute_cuda,
            "fused_add_layernorm": add_layernorm.fused_add_layernorm_cuda}


def launch_counts() -> dict:
    return {name: fn.launches for name, fn in kernel_wrappers().items()}


def reset_launch_counts() -> None:
    for fn in kernel_wrappers().values():
        fn.launches = 0
