"""Build and load the port's CUDA kernels.

Every ``csrc/*.cu`` is compiled for ``sm_90a`` by its own ``nvcc`` process,
all started together, and one more ``nvcc`` call links the objects into one
shared library with a plain C interface, which ``ctypes`` loads. The library
goes to ``_build/`` beside this file, named by a hash of the sources and flags,
so an edited source rebuilds and an unchanged one is reused. ptxas reports
each kernel's registers and spills (``-Xptxas -v``); the report is kept
beside the library and read by :func:`ptxas_report`. Nothing here runs at
import time: the first call of :func:`library` builds.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import time
from pathlib import Path
from typing import Optional

import torch

_HERE = Path(__file__).resolve().parent
CSRC = _HERE / "csrc"
BUILD_DIR = _HERE / "_build"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_F = ctypes.c_float
_SIGNATURES = {
    # x, w_qkv, b_qkv (block order), cos, sin, key_bias, qkv scratch, out,
    # B, N, heads, scale, side lengths (host int array), n_sides, stream
    "pram_self_attention": [_P] * 8 + [_I, _I, _I, _F, _P, _I, _P],
    # x, w, b, cos, sin, out0, out1, tokens, n_out, split, rot_cols, stream
    "pram_project_bf16": [_P] * 7 + [_L, _I, _I, _I, _P],
    # x, wq, ws, b, cos, sin, out0, out1, tokens, n_out, split, rot_cols,
    # stream
    "pram_project_int8": [_P] * 8 + [_L, _I, _I, _I, _P],
    # x, msg, wp, bp, w0, b0, ln_w, ln_b, w3, b3, out, tokens, eps, is_f32,
    # stream
    "pram_residual_mlp": [_P] * 11 + [_I, _F, _I, _P],
    # x, w ([to_qk | to_v] rows), b, bias0, bias1, qk scratch, v scratch,
    # out, B, N, n0, heads, scale, stream
    "pram_cross_attention": [_P] * 8 + [_I, _I, _I, _I, _F, _P],
    # qkv, cos, sin, key_bias, qr and kr scratch, out, row scratch, stat,
    # B, N, heads, scale, side lengths (host int array), n_sides, is_f32,
    # stream
    "pram_self_attention_qkv": [_P] * 9 + [_I, _I, _I, _F, _P, _I, _I, _P],
    # qk0, qk1, v0, v1, their frame strides, bias0, bias1, m0, m1, their
    # frame strides, row scratch, stat0, stat1, B, N, M, heads, scale,
    # is_f32, stream
    "pram_cross_attention_packed": [_P] * 4 + [_L] * 4 + [_P] * 4 + [_L] * 2 + [_P] * 3 + [_I] * 4 + [_F, _I, _P],
    # sim, r, c, bin, out, B, n, m, iters, cluster size (-1: the wide
    # instance), the wide instance's scratch, stream
    "pram_sinkhorn": [_P] * 5 + [_I] * 5 + [_P, _P],
    # n, m, cluster size and clusters placed at once (int pointers)
    "pram_sinkhorn_plan": [_I, _I, _P, _P],
    # descs, pdesc, kpts, uv, in_img, qmask, gate_r, ratio, nn_idx, d1, keep,
    # B, N, P, the real points of P, the descriptor width (128 or 256), stream
    "pram_refine_nn": [_P] * 6 + [_F, _F] + [_P] * 3 + [_I, _I, _I, _I, _I, _P],
    # cam, R, t, valid, xyz, uv, mask, threshold, out, P, K, N, slices of
    # the point axis, stream
    "pram_ransac_score": [_P] * 7 + [_F, _P, _I, _I, _I, _I, _P],
    # cam, R0, t0, xyz, uv, mask, threshold, min_inliers, damping, gn_iters,
    # lo_rounds, R, t, num, inliers, P, N, cluster size, stream
    "pram_gn_polish": [_P] * 6 + [_F, _F, _F, _I, _I] + [_P] * 4 + [_I, _I, _I, _P],
    # image, w1, b1, w2, b2, out, B, H, W, the image's pixels a row, is_bf16,
    # stream
    "pram_stem": [_P] * 6 + [_I] * 5 + [_P],
    # scores, out, B, H, W, radius, num_iters, is_bf16, stream
    "pram_nms": [_P] * 2 + [_I] * 6 + [_P],
    # qkv, cos, sin, key_bias, g, packed scratch, dqkv, dcos, dsin, dbias,
    # stats scratch, B, N, heads, scale, side lengths (host int array),
    # n_sides, stream
    "pram_self_attention_bwd": [_P] * 11 + [_I, _I, _I, _F, _P, _I, _P],
    # qk, v, bias0, bias1, g, dqk, dv, db0, db1, stats scratch, B, N, n0,
    # heads, scale, stream
    "pram_cross_attention_bwd": [_P] * 10 + [_I] * 4 + [_F, _P],
    # x, pm, ct, w0, b0, ln_w, ln_b, w3, dx, dpm, dw0, db0, dln_w, dln_b, dw3,
    # db3, y, dh, colsums and partial scratch, tokens, splits, vec_bf16,
    # eps, stream
    "pram_residual_mlp_bwd": [_P] * 20 + [_I, _I, _I, _F, _P],
    # x, msg, wpq, wps, bp, w0q, w0s, b0, ln_w, ln_b, w3q, w3s, b3, out,
    # tokens, eps, stream
    "pram_residual_mlp_int8": [_P] * 14 + [_I, _F, _P],
    # x, wq, ws, b, cos, sin, key_bias, qkv scratch, out, B, N, heads,
    # scale, side lengths (host int array), n_sides, stream
    "pram_self_attention_int8": [_P] * 9 + [_I, _I, _I, _F, _P, _I, _P],
    # x, wq, ws, b, bias0, bias1, qk and v scratch, out, B, N, n0, heads,
    # scale, stream
    "pram_cross_attention_int8": [_P] * 9 + [_I] * 4 + [_F, _P],
    # x, wq, scale, bias, in_scale, out, B, H, W, cin, x channel stride,
    # x channel offset, cout, out channel stride, out channel offset,
    # stride, bf16_tail, relu, stream
    "pram_conv3x3_int8": [_P] * 4 + [_F, _P] + [_I] * 12 + [_P],
    # x, w1, b1, w2, b2, mid scratch, out, B, H, W, cin, cmid, cout, stream
    "pram_conv_pair": [_P] * 7 + [_I] * 6 + [_P],
}

_LIB = None
BUILD_SECONDS = None  # wall time of the nvcc calls in this process (0.0 if cached)


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")


def library_path() -> Path:
    sources = sorted(CSRC.glob("*.cu"))
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for s in sources + sorted(CSRC.glob("*.cuh")):
        h.update(s.name.encode())
        h.update(s.read_bytes())
    return BUILD_DIR / f"libpram_kernels_{h.hexdigest()[:16]}.so"


def library() -> ctypes.CDLL:
    """Build (if needed) and load the kernel library."""
    global _LIB, BUILD_SECONDS
    if _LIB is not None:
        return _LIB
    so = library_path()
    if so.exists():
        BUILD_SECONDS = 0.0
    else:
        BUILD_DIR.mkdir(exist_ok=True)
        tmp = so.with_name(f"{so.stem}.{os.getpid()}.tmp.so")
        t0 = time.perf_counter()
        jobs = []
        for src in sorted(CSRC.glob("*.cu")):
            obj = so.with_name(f"{so.stem}.{src.stem}.{os.getpid()}.o")
            cmd = [_nvcc(), *NVCC_FLAGS, "-c", str(src), "-o", str(obj)]
            proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
            jobs.append((src, cmd, obj, proc))
        failed = []
        report = []
        for src, cmd, _, proc in jobs:
            out, err = proc.communicate()
            report.append(f"# {src.name}\n{err}")
            if proc.returncode:
                failed.append((cmd, proc.returncode, out, err))
        objs = [str(obj) for _, _, obj, _ in jobs]
        if not failed:
            cmd = [_nvcc(), *NVCC_FLAGS, "-shared", "-o", str(tmp), *objs]
            proc = subprocess.run(cmd, capture_output=True, text=True)
            if proc.returncode:
                failed.append((cmd, proc.returncode, proc.stdout, proc.stderr))
        BUILD_SECONDS = time.perf_counter() - t0
        for obj in objs:
            Path(obj).unlink(missing_ok=True)
        if failed:
            cmd, code, out, err = failed[0]
            raise RuntimeError(f"nvcc failed ({code}):\n{' '.join(cmd)}\n{out}\n{err}")
        so.with_suffix(".ptxas.txt").write_text("".join(report))
        os.replace(tmp, so)
    lib = ctypes.CDLL(str(so))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    _LIB = lib
    return lib


def _short_name(mangled: str) -> str:
    """The kernel's own name from its mangled one: the last component of
    ``_ZN<n><namespace>...<n><name>``, e.g. ``grad_kernel``, with a
    template's arguments after it (type names, builtin type letters,
    integer values), e.g. ``conv3x3_kernel<a,1,256,0>``."""
    if not mangled.startswith("_ZN"):
        return mangled
    rest, name = mangled[3:], mangled
    while (m := re.match(r"\d+", rest)) is not None:
        name = rest[m.end():m.end() + int(m.group())]
        rest = rest[m.end() + int(m.group()):]
    if not rest.startswith("I"):
        return name
    args, i, depth = [], 1, 1  # type names, builtin type letters, integer literals
    while i < len(rest) and depth:
        ch = rest[i]
        if ch.isdigit():
            m = re.match(r"\d+", rest[i:])
            j = i + m.end()
            args.append(rest[j:j + int(m.group())])
            i = j + int(m.group())
        elif ch == "L":
            j = rest.index("E", i)
            args.append(rest[i + 2:j])
            i = j + 1
        else:
            depth += 1 if ch in "IN" else -1 if ch == "E" else 0
            if ch not in "INE":
                args.append(ch)
            i += 1
    return f"{name}<{','.join(args)}>"


def ptxas_report(source: str) -> list:
    """What ptxas said of each kernel of ``csrc/<source>`` when the loaded
    library was built: ``[{"kernel", "registers", "spill_stores",
    "spill_loads", "stack", "notes"}]`` (spills and the stack frame, where
    arrays indexed at run time live, in bytes; ``notes``: ptxas's warnings
    and performance remarks on the kernel)."""
    path = library_path().with_suffix(".ptxas.txt")
    text = path.read_text() if path.exists() else ""
    section = text.split(f"# {source}\n", 1)[1].split("\n# ", 1)[0] if f"# {source}\n" in text else ""
    kernels, current = [], None
    for line in section.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            current = dict(kernel=_short_name(m.group(1)), registers=None, spill_stores=None,
                           spill_loads=None, stack=None, notes=[])
            kernels.append(current)
            continue
        if current is None:
            continue
        m = re.search(r"(\d+) bytes stack frame", line)
        if m:
            current["stack"] = int(m.group(1))
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            current["spill_stores"], current["spill_loads"] = int(m.group(1)), int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            current["registers"] = int(m.group(1))
        if "warning" in line or "Performance" in line:
            current["notes"].append(line.strip())
    return kernels


def check_status(status: int, name: str) -> None:
    """Raise if a kernel's C entry returned a CUDA error code."""
    if status != 0:
        raise RuntimeError(f"{name} failed with CUDA error {status}")


def check_tensor(t: torch.Tensor, name: str, shape, dtype, device) -> None:
    """Raise unless ``t`` has this device, dtype and shape and is contiguous."""
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} is not contiguous")


def ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def ptr_or_null(t: Optional[torch.Tensor]) -> ctypes.c_void_p:
    """``ptr(t)``, or a null pointer for an output the caller did not ask for."""
    return ctypes.c_void_p(None) if t is None else ptr(t)


def stream_of(device) -> ctypes.c_void_p:
    """PyTorch's current stream on ``device`` (a tensor's, so with its index),
    for a launch: the raw handle, without building the ``torch.cuda.Stream``
    that ``torch.cuda.current_stream`` returns (a fifth of a short kernel
    call's host time)."""
    return ctypes.c_void_p(torch._C._cuda_getCurrentRawStream(device.index))
