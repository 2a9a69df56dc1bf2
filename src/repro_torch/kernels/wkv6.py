"""wkv6: the chunked RWKV6 (Finch) recurrence.

Per (batch, head) row, over S steps with a [hd, hd] fp32 state:
``y_t = r_t (S + diag(u) k_t^T v_t)`` and ``S <- diag(e^{w_t}) S + k_t^T v_t``,
computed in chunks of ``Q = min(16, S)`` steps with the JAX package's
log-space factorization (``kernels/wkv6.py::_kernel`` there, and the chunk
body of ``models/ssm.py::rwkv6_time_mix_chunked``): with ``l`` the
cumulative log decay inside a chunk and ``lprev = l - w``,
``y = tril_-1((r e^lprev)(k e^-l)^T) v + (sum r u k) v + (r e^lprev) S``
and ``S <- e^{l_Q} S + (k e^{l_Q - l})^T v``. ``w_log`` is clamped by the
caller to [-5, -1e-4], so ``e^-l`` stays finite in fp32 at Q = 16.

Unlike the TPU kernel, which starts from a zero state and drops it, both
versions here take an optional initial state and return the final one:
the decode and serving paths carry it on.

The CUDA kernel is ``csrc/wkv6.cu``: each chunk's tiles come in by bulk
copies through a ring of three shared-memory stages, two teams of
producer warps compute the chunk-local terms ahead of the serial chain,
and consumer warps keep only the two state terms on it, on the tensor
cores in 3xTF32 with the state in registers. A row's hd value columns
split across G blocks (:func:`column_groups`); each column's arithmetic
is the same for any split, so the result depends on neither the split nor
BH.
:func:`wkv6_plain` is the plain PyTorch version of the same chunk body: it
is what a CPU tensor runs, and what the kernel is held to on the card:
about 1e-5 relative for fp32 inputs (the sums run in another order),
about 2e-2 for bf16 (one bf16 rounding of the output).
"""
from __future__ import annotations

import functools
from typing import Optional, Tuple

import torch

from repro_torch.kernels._build import (LaunchCounter, check, library,
                                        refuse_grad)

CHUNK = 16
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (32, 64)
GROUPS = (1, 2, 4)          # column groups a row can split into
CONSUMER_COLUMNS = 16       # columns of one consumer warp

launches = LaunchCounter()


def column_groups(BH: int, hd: int, n_sm: int) -> int:
    """G, the blocks a row's hd columns split into: the most (a power of
    two, at least 16 columns each) that keep the BH * G blocks within one
    wave of the card's ``n_sm`` SMs; 1 when BH alone fills them. Each
    block recomputes the chunk-local terms, so a split past one wave adds
    work without adding SMs. From (BH, hd, n_sm) alone."""
    G = 1
    while (2 * G in GROUPS and hd % (2 * G * CONSUMER_COLUMNS) == 0
           and BH * 2 * G <= n_sm):
        G *= 2
    return G


def check_groups(hd: int, groups: int) -> int:
    """``groups`` if the kernel splits head_dim ``hd`` that way, else raise."""
    if groups not in GROUPS or hd % (groups * CONSUMER_COLUMNS):
        raise ValueError(f"wkv6 splits head_dim {hd} into groups of "
                         f"{CONSUMER_COLUMNS} columns or more, a power of "
                         f"two: groups = {groups} is not one")
    return groups


def launch_plan(BH: int, hd: int, n_sm: int,
                groups: Optional[int] = None) -> int:
    """The column groups of a launch: :func:`column_groups` unless
    ``groups`` is given (:func:`check_groups`)."""
    if groups is None:
        return column_groups(BH, hd, n_sm)
    return check_groups(hd, groups)


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def chunk_len(S: int) -> int:
    """The chunk Q = min(16, S); S must be a multiple of it."""
    Q = min(CHUNK, S)
    if S < 1 or S % Q:
        raise ValueError(f"wkv6 runs S in chunks of {CHUNK}: S = {S} is "
                         f"neither at most {CHUNK} nor a multiple of it")
    return Q


def _check_shapes(r, k, v, w_log, u, state):
    if r.ndim != 3:
        raise ValueError(f"r must be [BH, S, hd], got {tuple(r.shape)}")
    BH, S, hd = r.shape
    for name, t in (("k", k), ("v", v), ("w_log", w_log)):
        if tuple(t.shape) != (BH, S, hd):
            raise ValueError(f"{name} {tuple(t.shape)} != r {tuple(r.shape)}")
    if tuple(u.shape) != (BH, hd):
        raise ValueError(f"u must be [BH, hd] = {(BH, hd)}, got "
                         f"{tuple(u.shape)}")
    if state is not None and tuple(state.shape) != (BH, hd, hd):
        raise ValueError(f"state must be [BH, hd, hd] = {(BH, hd, hd)}, got "
                         f"{tuple(state.shape)}")
    return BH, S, hd


def wkv6_plain(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               w_log: torch.Tensor, u: torch.Tensor,
               state: Optional[torch.Tensor] = None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version: the chunk body over [BH, nc, Q, hd] in fp32,
    chunk after chunk. Returns (y in r's dtype, final state fp32)."""
    BH, S, hd = _check_shapes(r, k, v, w_log, u, state)
    Q = chunk_len(S)
    nc = S // Q

    def chunks(t):
        return t.to(torch.float32).reshape(BH, nc, Q, hd)
    rc, kc, vc, wc = map(chunks, (r, k, v, w_log))
    uf = u.to(torch.float32)[:, None, :]
    Scur = (torch.zeros((BH, hd, hd), dtype=torch.float32, device=r.device)
            if state is None else state.to(torch.float32))
    strict = torch.ones((Q, Q), dtype=torch.bool, device=r.device).tril(-1)
    ys = []
    for c in range(nc):
        rq, kq, vq, lw = rc[:, c], kc[:, c], vc[:, c], wc[:, c]  # [BH, Q, hd]
        l = torch.cumsum(lw, dim=1)
        lprev = l - lw
        r_dec = rq * torch.exp(lprev)
        k_inv = kq * torch.exp(-l)
        A = torch.where(strict, r_dec @ k_inv.transpose(1, 2), 0.0)
        bonus = torch.sum(rq * (uf * kq), dim=-1, keepdim=True)
        ys.append(A @ vq + bonus * vq + r_dec @ Scur)
        k_tail = kq * torch.exp(l[:, -1:] - l)
        Scur = (torch.exp(l[:, -1])[..., None] * Scur
                + k_tail.transpose(1, 2) @ vq)
    y = torch.stack(ys, dim=1).reshape(BH, S, hd)
    return y.to(r.dtype), Scur


def wkv6(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
         w_log: torch.Tensor, u: torch.Tensor,
         state: Optional[torch.Tensor] = None
         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """r, k, v, w_log [BH, S, hd]; u [BH, hd] (one dtype, fp32 or bf16);
    state [BH, hd, hd] fp32 or None (zeros) -> (y [BH, S, hd] in r's dtype,
    final state [BH, hd, hd] fp32). S must be at most 16 or a multiple of
    16.

    A CUDA tensor launches the kernel or raises; a CPU tensor takes
    :func:`wkv6_plain`."""
    return _wkv6(r, k, v, w_log, u, state, None)


def _wkv6(r, k, v, w_log, u, state, groups: Optional[int]):
    """:func:`wkv6` with the launch's column groups forced (None: the
    plan's), for the tests and the sweep that hold every split to the
    planned one. ``groups`` is checked on either device."""
    BH, S, hd = _check_shapes(r, k, v, w_log, u, state)
    chunk_len(S)
    if r.device.type == "cpu":
        if groups is not None:
            check_groups(hd, groups)
        return wkv6_plain(r, k, v, w_log, u, state)
    if r.device.type != "cuda":
        raise ValueError(f"wkv6: unsupported device {r.device}")
    refuse_grad("wkv6", r, k, v, w_log, u, state)
    if r.dtype not in DTYPES or any(t.dtype != r.dtype
                                    for t in (k, v, w_log, u)):
        got = [str(t.dtype) for t in (r, k, v, w_log, u)]
        raise TypeError(f"wkv6 takes r, k, v, w_log and u of one dtype, fp32 "
                        f"or bf16; got {got}")
    if state is not None and state.dtype != torch.float32:
        raise TypeError(f"wkv6 takes an fp32 state, got {state.dtype}")
    if hd not in HEAD_DIMS:
        raise ValueError(f"wkv6 takes head_dim in {HEAD_DIMS}, got {hd}")
    tensors = [t for t in (r, k, v, w_log, u, state) if t is not None]
    if any(t.device != r.device for t in tensors):
        raise ValueError("wkv6 inputs lie on different devices")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("wkv6 takes contiguous inputs")
    if any(t.data_ptr() % 16 for t in tensors):
        raise ValueError("wkv6 reads its inputs in vectors: they must be "
                         "16-byte aligned")
    G = launch_plan(BH, hd,
                    _sm_count(r.device.index if r.device.index is not None
                              else torch.cuda.current_device()), groups)
    y = torch.empty_like(r)
    s_out = torch.empty((BH, hd, hd), dtype=torch.float32, device=r.device)
    if BH == 0:
        return y, s_out
    err = library().repro_wkv6(
        r.data_ptr(), k.data_ptr(), v.data_ptr(), w_log.data_ptr(),
        u.data_ptr(), None if state is None else state.data_ptr(),
        y.data_ptr(), s_out.data_ptr(), BH, S, hd, DTYPES[r.dtype], G,
        torch.cuda.current_stream(r.device).cuda_stream)
    check(err, "wkv6 kernel launch")
    launches.bump((BH, S, hd, str(r.dtype).replace("torch.", ""),
                   state is not None))
    return y, s_out
