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

Training: where autograd records the call (grad mode on and an input
requiring grad) :func:`wkv6` runs through :class:`WKV6Fn`, whose forward
is the same launch. The TPU kernel has no ``custom_vjp``: the JAX package
trains rwkv6 through XLA's autodiff of the jnp chunked time-mix, whose
chunk body is this one. The backward is therefore torch ops too,
:func:`wkv6_grad`: it recomputes the chunk-entry states with a scan of
the chunk update, carries the state's gradient back over the chunks, and
takes each chunk's gradients in the forward's factorization, with the
products in the forward's order so that ``e^-l`` (up to e^80 at the
clamp) only ever meets the factor that bounds it; the decay's gradient
it sums term by term, where autograd's difference of sums cancels terms
up to e^5 larger than the result.
"""
from __future__ import annotations

import functools
from typing import Optional, Tuple

import torch

from repro_torch.kernels._build import (LaunchCounter, check, library,
                                        needs_grad)

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
    """Plain PyTorch version: the chunk body over [BH, nc, Q, hd] in fp32
    (fp64 for fp64 inputs, the tests' exact reference), chunk after chunk.
    Returns (y in r's dtype, final state in the working type)."""
    BH, S, hd = _check_shapes(r, k, v, w_log, u, state)
    Q = chunk_len(S)
    nc = S // Q
    wt = torch.promote_types(r.dtype, torch.float32)

    def chunks(t):
        return t.to(wt).reshape(BH, nc, Q, hd)
    rc, kc, vc, wc = map(chunks, (r, k, v, w_log))
    uf = u.to(wt)[:, None, :]
    Scur = (torch.zeros((BH, hd, hd), dtype=wt, device=r.device)
            if state is None else state.to(wt))
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


def wkv6_grad(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              w_log: torch.Tensor, u: torch.Tensor,
              state: Optional[torch.Tensor], dy: torch.Tensor,
              dstate_fin: torch.Tensor):
    """The gradient of :func:`wkv6` at (r, k, v, w_log, u, state), given
    the gradients of its outputs, ``dy`` [BH, S, hd] and ``dstate_fin``
    [BH, hd, hd]: (dr, dk, dv, dw_log, du, dstate), each in its input's
    dtype and computed in fp32; dstate is None when state is.

    Per chunk, in the module docstring's notation (``r~ = r e^lprev``,
    ``k~ = k e^-l``, ``k^ = k e^(l_Q - l)``, ``A = tril_-1(r~ k~^T)``,
    ``b = sum r u k``), with S the chunk's entry state and dS' the
    gradient of its exit state: ``dA = tril_-1(dy v^T)``,
    ``dv = A^T dy + b dy + k^ dS'``, ``db = sum dy v``,
    ``dr~ = dA k~ + dy S^T``, ``dk~ = dA^T r~``, ``dk^ = v dS'^T``,
    ``dS = r~^T dy + e^l_Q dS'``; then ``dr = dr~ e^lprev + db u k``,
    ``dk = dk~ e^-l + dk^ e^(l_Q - l) + db u r`` and ``du = sum db r k``
    over every chunk. The products run in the forward's order, so e^-l
    (up to e^80 at the clamp) meets only the factor that bounds it.

    The decay's gradient is ``revcumsum(dl + dlprev) - dlprev`` with
    ``dlprev = dr~ r~`` and ``dl = -dk~ k~ - dk^ k^`` (plus, at the
    chunk's last step, ``sum_t dk^ k^ + sum_j dS' e^l_Q S``). Summed so,
    it cancels terms up to e^5 larger than itself where the decays sit at
    the clamp, so it is summed term by term instead: ``dw_m`` gathers A's
    pairs (t, s) with s < m < t, ``dA_ts r_t k_s e^(lprev_t - l_s)``
    (each factor e^.. <= 1), the state's ``(dy S^T) r~`` at t > m, the
    tail's ``dk^ k^`` at t < m, and ``e^l_Q sum_j dS' S`` at every m; the
    masked sums are matmuls with 0 / 1 matrices.

    The entry states come from a scan of the forward's chunk update (BH x
    S / Q x hd x hd fp32, the state's gradient likewise); every product
    inside a chunk is one batched matmul over all chunks."""
    BH, S, hd = _check_shapes(r, k, v, w_log, u, state)
    Q = chunk_len(S)
    nc = S // Q
    f32 = torch.float32

    def chunks(t):
        return t.to(f32).reshape(BH, nc, Q, hd)
    rc, kc, vc, wc, dyc = map(chunks, (r, k, v, w_log, dy))
    uf = u.to(f32)[:, None, None, :]
    l = torch.cumsum(wc, dim=2)
    lprev = l - wc
    e_lprev, e_negl = torch.exp(lprev), torch.exp(-l)
    e_tail = torch.exp(l[:, :, -1:] - l)
    decay = torch.exp(l[:, :, -1])[..., None]            # [BH, nc, hd, 1]
    r_dec, k_inv, k_tail = rc * e_lprev, kc * e_negl, kc * e_tail

    # the chunk-entry states, as the forward's scan builds them
    kv = k_tail.transpose(-1, -2) @ vc                   # [BH, nc, hd, hd]
    s_in = torch.empty_like(kv)
    scur = (torch.zeros((BH, hd, hd), dtype=f32, device=r.device)
            if state is None else state.to(f32))
    for c in range(nc):
        s_in[:, c] = scur
        scur = decay[:, c] * scur + kv[:, c]
    del kv
    # the exit states' gradients dS', carried back from dstate_fin
    ds_out = r_dec.transpose(-1, -2) @ dyc               # r~^T dy, then dS'
    dcur = dstate_fin.to(f32)
    for c in reversed(range(nc)):
        entry = ds_out[:, c] + decay[:, c] * dcur
        ds_out[:, c] = dcur
        dcur = entry

    strict = torch.ones((Q, Q), dtype=torch.bool, device=r.device).tril(-1)
    A = torch.where(strict, r_dec @ k_inv.transpose(-1, -2), 0.0)
    dA = torch.where(strict, dyc @ vc.transpose(-1, -2), 0.0)
    bonus = torch.sum(rc * (uf * kc), dim=-1, keepdim=True)
    dbonus = torch.sum(dyc * vc, dim=-1, keepdim=True)
    dv = A.transpose(-1, -2) @ dyc + bonus * dyc + k_tail @ ds_out
    del A
    dy_s = dyc @ s_in.transpose(-1, -2)                  # dy S^T
    dk_tail = vc @ ds_out.transpose(-1, -2)
    dr = (dA @ k_inv + dy_s) * e_lprev + dbonus * uf * kc
    dk = ((dA.transpose(-1, -2) @ r_dec) * e_negl + dk_tail * e_tail
          + dbonus * uf * rc)
    du = torch.sum(dbonus * rc * kc, dim=(1, 2))

    before = strict.to(f32)                              # [m, t]: t < m
    straddle = (before.T[:, :, None] * before[:, None, :]).reshape(Q, Q * Q)
    pairs = torch.where(strict[:, :, None],
                        lprev[:, :, :, None] - l[:, :, None], -torch.inf)
    pairs.exp_().mul_(kc[:, :, None]).mul_(rc[:, :, :, None])
    pairs.mul_(dA[..., None])                            # [.., t, s, hd]
    dw = straddle @ pairs.reshape(BH, nc, Q * Q, hd)
    del pairs
    dw += (before.T @ (dy_s * r_dec) + before @ (dk_tail * k_tail)
           + (decay[..., 0] * torch.sum(ds_out * s_in, dim=-1))[:, :, None])

    def rows(t, like):
        return t.reshape(BH, S, hd).to(like.dtype)
    return (rows(dr, r), rows(dk, k), rows(dv, v), rows(dw, w_log),
            du.to(u.dtype), None if state is None else dcur.to(state.dtype))


class WKV6Fn(torch.autograd.Function):
    """:func:`wkv6` under autograd: the forward is the kernel (the plain
    version on the CPU), the backward :func:`wkv6_grad`. Both outputs are
    differentiable; an unused final state brings a zero gradient."""

    @staticmethod
    def forward(ctx, r, k, v, w_log, u, state):
        y, s_fin = _wkv6(r, k, v, w_log, u, state, None)
        ctx.save_for_backward(r, k, v, w_log, u, state)
        return y, s_fin

    @staticmethod
    def backward(ctx, dy, dstate_fin):
        return wkv6_grad(*ctx.saved_tensors, dy, dstate_fin)


def wkv6(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
         w_log: torch.Tensor, u: torch.Tensor,
         state: Optional[torch.Tensor] = None
         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """r, k, v, w_log [BH, S, hd]; u [BH, hd] (one dtype, fp32 or bf16);
    state [BH, hd, hd] fp32 or None (zeros) -> (y [BH, S, hd] in r's dtype,
    final state [BH, hd, hd] fp32). S must be at most 16 or a multiple of
    16.

    A CUDA tensor launches the kernel or raises; a CPU tensor takes
    :func:`wkv6_plain`. Where autograd records the call, it runs through
    :class:`WKV6Fn`."""
    if needs_grad(r, k, v, w_log, u, state):
        return WKV6Fn.apply(r, k, v, w_log, u, state)
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
