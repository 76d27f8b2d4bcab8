"""Fused relative-position attention: CUDA kernels, plain version, wrapper.

Counterpart of the JAX package's ``ops/attention_pallas.py``. Two CUDA
sources replace its two Pallas kernels:

- ``csrc/relpos_attention_fwd.cu`` (``_fwd_kernel``) computes, in the JAX
  (B, H, T, Dh) layout,

      softmax((q_u k^T + rel_shift(q_v p^T)) * scale + am_add + kp_add)
          -> dropout -> @ v

  every product on the tensor cores in 3xTF32 (f32 accuracy), and, when
  a gradient will be asked for, each row's softmax statistics
  (B, H, T, 2): the row max and 1 / row sum of the scaled scores;
- ``csrc/relpos_attention_bwd.cu`` (``_bwd_kernel``) recomputes the
  probabilities from those statistics and emits dq_u, dq_v, dk, dv and dp,
  every product on the tensor cores in 3xTF32 (f32 accuracy). dp sums over
  the batch: one pass writes a partial per (batch element, head, tile
  diagonal), a second adds them in a fixed order, so the result is
  deterministic.

Dropout is a counter-based Philox4x32-10 draw keyed by the seed and
counted by (b, h, i, j): word 0 of ``philox(ctr=(j, i, h, b), key=(seed
low, seed high))``; an element is kept iff that u32 is at least
``floor(rate * 2**32)``, and kept probabilities are scaled by
``1 / (1 - rate)``, as the JAX kernel does with the TPU's own bits. The
forward and the backward regenerate one mask bit for bit, and
``philox_keep_mask`` computes the same bits in int64 tensor arithmetic,
so the plain version and the kernels drop the same elements. ``h0``
(every C entry's last argument, the plain version's keyword) is the
first head of the launch among the whole model's: a tensor-parallel
rank launches heads [h0, h0 + H) of them, and h counts from h0, so it
draws the masks the whole launch draws for those heads.

bf16 (the JAX package's production precision): both sources also hold a
bf16 variant (``relpos_attention_fwd_bf16``, ``relpos_attention_bwd_bf16``)
that rounds where the JAX kernels round with bf16 operands: q_u, q_v, k,
v, p and the output gradient in bf16, every product on the tensor cores
in bf16 with f32 accumulation (``csrc/mma_bf16.cuh``), the scores, the
rel-shift, the softmax and the dropout scaling in f32, the probabilities
rounded to bf16 before ``@ v``, dS rounded to bf16 before the dq, dk and
dp products, dp summed over the batch in f32 and rounded once, the masks
and the statistics f32. The wrapper dispatches on q_u's dtype: f32 to the
f32 kernels, bf16 to the bf16 kernels, anything else raises.

The bf16 forward has two routes, chosen by T before the launch
(``bf16_fwd_route``): the resident kernel keeps each block's rows of
scores whole in shared memory and takes every T up to
``bf16_fwd_max_t(Dh)`` (3264 keys at Dh 33-64, as the built kernel's C
entry says); past that the two-pass kernel, which holds no row of scores,
takes it. So has the bf16 backward (``bf16_bwd_route``): the resident
route computes each score once, its rows of P and dP in shared memory,
dS and Pd through a (B, H, T, roundup(T, 64)) bf16 scratch for the
key-major products, up to ``bf16_bwd_max_t(Dh)`` (1600 at Dh 33-64);
past that the five passes that recompute the scores in each.

``relpos_attention_reference`` is the plain PyTorch version of the whole
function: in f32 (or f64) autograd gives its backward; in bf16 it rounds
where the kernels do and its backward is ``relpos_attention_bwd_bf16``,
the JAX backward kernel's arithmetic written out (autograd would round
elsewhere). ``fused_relpos_attention`` takes the plain version only for
tensors on the CPU; on CUDA it launches the kernels (through a
``torch.autograd.Function`` when a gradient is needed) or raises.
``launches`` and ``bwd_launches`` count the launches of the f32 forward
and backward, ``bf16_launches`` and ``bf16_bwd_launches`` those of the
bf16 variants' resident routes, ``bf16_long_launches`` and
``bf16_bwd_long_launches`` those of their long routes.
"""

import ctypes
import functools

import torch

from tsasr_torch.kernels import _build
from tsasr_torch.utils.precision import f32_or_wider

MAX_HEAD_DIM = 128
SOURCE = "relpos_attention_fwd"
BWD_SOURCE = "relpos_attention_bwd"

PHILOX_M0 = 0xD2511F53
PHILOX_M1 = 0xCD9E8D57
PHILOX_W0 = 0x9E3779B9
PHILOX_W1 = 0xBB67AE85
MASK32 = 0xFFFFFFFF

launches = 0
bwd_launches = 0
bf16_launches = 0
bf16_bwd_launches = 0
bf16_long_launches = 0
bf16_bwd_long_launches = 0
# the kernels' element types
DTYPES = (torch.float32, torch.bfloat16)


@functools.cache
def bf16_fwd_max_t(dh):
    """The largest T the bf16 forward's resident kernel takes at head dim
    ``dh`` (its f32 rows of scores fill a block's shared memory past it),
    from the built kernel's C entry ``relpos_attention_fwd_bf16_max_t``."""
    if not 1 <= dh <= MAX_HEAD_DIM:
        raise ValueError(f"head dim {dh} outside 1..{MAX_HEAD_DIM}")
    fn = _build.load(SOURCE).relpos_attention_fwd_bf16_max_t
    fn.argtypes = [ctypes.c_int]
    fn.restype = ctypes.c_int
    return fn(dh)


def bf16_fwd_route(T, dh):
    """"resident" where the bf16 forward's rows of scores fit a block's
    shared memory, else "long" (the two-pass kernel)."""
    return "resident" if T <= bf16_fwd_max_t(dh) else "long"


@functools.cache
def bf16_bwd_max_t(dh):
    """The largest T the bf16 backward's resident route takes at head dim
    ``dh`` (its f32 rows of P and dP fill a block's shared memory past
    it), from the built kernel's C entry
    ``relpos_attention_bwd_bf16_max_t``."""
    if not 1 <= dh <= MAX_HEAD_DIM:
        raise ValueError(f"head dim {dh} outside 1..{MAX_HEAD_DIM}")
    fn = _build.load(BWD_SOURCE).relpos_attention_bwd_bf16_max_t
    fn.argtypes = [ctypes.c_int]
    fn.restype = ctypes.c_int
    return fn(dh)


def bf16_bwd_route(T, dh):
    """"resident" where the bf16 backward's rows of P and dP fit a
    block's shared memory, else "long" (the five passes)."""
    return "resident" if T <= bf16_bwd_max_t(dh) else "long"


def rel_shift(x, klen, causal=False):
    """Transformer-XL rel-shift: (..., T, 2T-1) scores against relative
    positions -> (..., T, klen) with column j of row i holding entry
    ``T-1-i+j`` of that row. ``causal`` zeroes the shifted scores' future
    triangle before the slice, as the JAX ``_rel_shift`` does for a
    causal model (the triangle lies past the columns kept)."""
    *lead, qlen, pos_len = x.shape
    x = torch.nn.functional.pad(x, (1, 0))
    x = x.reshape(*lead, pos_len + 1, qlen)
    x = x[..., 1:, :].reshape(*lead, qlen, pos_len)
    if causal:
        tri = torch.ones(qlen, pos_len, dtype=torch.bool, device=x.device)
        x = x * tri.tril(pos_len - qlen)
    return x[..., :pos_len // 2 + 1][..., :klen]


# ------------------------------------------------------------- dropout bits
def _mulhilo(a, m):
    """(hi, lo) 32-bit words of ``a * m`` for int64 ``a`` < 2**32 and a
    constant ``m`` < 2**32, without overflowing int64."""
    x = a * (m & 0xFFFF)                         # < 2**48
    y = a * (m >> 16) + (x >> 16)                # < 2**48 + 2**32
    return y >> 16, ((y & 0xFFFF) << 16) | (x & 0xFFFF)


def philox4x32(c0, c1, c2, c3, k0, k1, rounds=10):
    """Philox4x32-10 on int64 tensors holding u32 words."""
    for _ in range(rounds):
        hi0, lo0 = _mulhilo(c0, PHILOX_M0)
        hi1, lo1 = _mulhilo(c2, PHILOX_M1)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
        k0 = (k0 + PHILOX_W0) & MASK32
        k1 = (k1 + PHILOX_W1) & MASK32
    return c0, c1, c2, c3


def dropout_threshold(rate):
    """u32 threshold: an element is kept iff its draw is >= this."""
    return int(rate * float(2 ** 32)) & MASK32


def philox_keep_mask(seed, B, H, T, rate, device=None, h0=0):
    """(B, H, T, T) bool keep mask of the fused attention's dropout, the
    heads counted from ``h0``."""
    seed = _seed_tensor(seed, device or "cpu")
    ar = functools.partial(torch.arange, dtype=torch.int64, device=seed.device)
    shape = (B, H, T, T)
    j = ar(T).view(1, 1, 1, T).expand(shape)
    i = ar(T).view(1, 1, T, 1).expand(shape)
    h = (h0 + ar(H)).view(1, H, 1, 1).expand(shape)
    b = ar(B).view(B, 1, 1, 1).expand(shape)
    word, *_ = philox4x32(j, i, h, b, seed & MASK32, (seed >> 32) & MASK32)
    return word >= dropout_threshold(rate)


def _seed_tensor(seed, device):
    if isinstance(seed, torch.Tensor):
        return seed.to(device=device, dtype=torch.int64).reshape(1)
    return torch.tensor([int(seed)], dtype=torch.int64, device=device)


# ------------------------------------------------------------ plain version
def relpos_attention_reference(q_u, q_v, k, v, p, kp_add, am_add, scale,
                               seed=0, rate=0.0, h0=0):
    """Plain PyTorch version of the kernels, dropout included.

    q_u, q_v, k, v: (B, H, T, Dh); p: (H, 2T-1, Dh); kp_add: (B, T) and
    am_add: (T, T) additive f32 masks (0 or -1e9); seed: int or integer
    tensor; rate: dropout rate on the probabilities; h0: the first
    head's index among the model's, which the dropout counts from. bf16
    operands round as the bf16 kernels do, with
    ``relpos_attention_bwd_bf16`` as the backward.
    """
    if q_u.dtype == torch.bfloat16:
        return _PlainBf16Attention.apply(q_u, q_v, k, v, p, kp_add, am_add,
                                         seed, scale, rate, h0)
    B, H, T, _ = q_u.shape
    ac = torch.einsum("bhtd,bhsd->bhts", q_u, k)
    bd = rel_shift(torch.einsum("bhtd,hsd->bhts", q_v, p), klen=T)
    scores = ((ac + bd) * scale + am_add[None, None]
              + kp_add[:, None, None, :])
    probs = torch.softmax(scores, dim=-1, dtype=f32_or_wider(scores))
    if rate > 0.0:
        keep = philox_keep_mask(seed, B, H, T, rate, q_u.device, h0)
        probs = torch.where(keep, probs * (1.0 / (1.0 - rate)), 0.0)
    return torch.einsum("bhts,bhsd->bhtd", probs.to(v.dtype), v)


def _bf16_probs(q_u, q_v, k, p, kp_add, am_add, scale):
    """The JAX kernel's ``_probs_in_tile`` on bf16 operands: products of
    the bf16 values summed in f32, the rel-shift, masks and softmax in
    f32. Returns the f32 probabilities (B, H, T, T)."""
    T = q_u.shape[2]
    f32 = torch.float32
    ac = torch.einsum("bhtd,bhsd->bhts", q_u.to(f32), k.to(f32))
    bd = rel_shift(torch.einsum("bhtd,hsd->bhts", q_v.to(f32), p.to(f32)),
                   klen=T)
    scores = ((ac + bd) * scale + am_add[None, None]
              + kp_add[:, None, None, :])
    return torch.softmax(scores, dim=-1)


def _bf16_dropped(probs, seed, rate, h0=0):
    """(keep mask or None, probabilities after dropout, f32)."""
    if rate <= 0.0:
        return None, probs
    B, H, T, _ = probs.shape
    keep = philox_keep_mask(seed, B, H, T, rate, probs.device, h0)
    return keep, torch.where(keep, probs * (1.0 / (1.0 - rate)), 0.0)


def _bf16_product(equation, a, b):
    """A product of bf16 operands with f32 accumulation, in f32."""
    return torch.einsum(equation, a.to(torch.bfloat16).float(),
                        b.to(torch.bfloat16).float())


def relpos_attention_fwd_bf16(q_u, q_v, k, v, p, kp_add, am_add, scale,
                              seed=0, rate=0.0, h0=0):
    """Plain bf16 forward (JAX ``_fwd_kernel`` with bf16 operands): the
    dropped probabilities rounded to bf16, ``@ v`` summed in f32, the
    output rounded to bf16."""
    probs = _bf16_probs(q_u, q_v, k, p, kp_add, am_add, scale)
    _, pd = _bf16_dropped(probs, seed, rate, h0)
    return _bf16_product("bhts,bhsd->bhtd", pd, v).to(torch.bfloat16)


def unshift(ds, P):
    """Adjoint of ``rel_shift`` (non-causal): (..., T, T) -> (..., T, P)
    with column T-1-i+j of row i holding ds[..., i, j], zeros elsewhere."""
    *lead, T, _ = ds.shape
    i = torch.arange(T, device=ds.device)
    col = (T - 1 - i[:, None] + i[None, :]).expand(*lead, T, T)
    return torch.zeros(*lead, T, P, dtype=ds.dtype,
                       device=ds.device).scatter_(-1, col, ds)


def relpos_attention_bwd_bf16(q_u, q_v, k, v, p, kp_add, am_add, do, scale,
                              seed=0, rate=0.0, h0=0):
    """Plain bf16 backward (JAX ``_bwd_kernel`` with bf16 operands):
    dv = bf16(Pd)^T do and dP = do v^T summed in f32; the softmax
    jacobian in f32; dS rounded to bf16 for dq_u and dk; dS un-shifted
    in f32, then rounded to bf16 for dq_v and dp; dp summed over the
    batch in f32 and rounded once. Returns (dq_u, dq_v, dk, dv, dp) in
    bf16."""
    bf16 = torch.bfloat16
    do = do.to(bf16)
    probs = _bf16_probs(q_u, q_v, k, p, kp_add, am_add, scale)
    keep, pd = _bf16_dropped(probs, seed, rate, h0)
    dv = _bf16_product("bhts,bhtd->bhsd", pd, do)
    dprobs = _bf16_product("bhtd,bhsd->bhts", do, v)
    if keep is not None:
        dprobs = torch.where(keep, dprobs * (1.0 / (1.0 - rate)), 0.0)
    row = (probs * dprobs).sum(dim=-1, keepdim=True)
    dscores = probs * (dprobs - row) * scale
    dqu = _bf16_product("bhts,bhsd->bhtd", dscores, k)
    dk = _bf16_product("bhts,bhtd->bhsd", dscores, q_u)
    dbdf = unshift(dscores, p.shape[1])
    dqv = _bf16_product("bhtr,hrd->bhtd", dbdf, p)
    dp = _bf16_product("bhtr,bhtd->hrd", dbdf, q_v)
    return tuple(g.to(bf16) for g in (dqu, dqv, dk, dv, dp))


class _PlainBf16Attention(torch.autograd.Function):
    """The plain bf16 forward with the plain bf16 backward: the JAX
    custom VJP's rounding, which autograd through the forward would not
    give."""

    @staticmethod
    def forward(ctx, q_u, q_v, k, v, p, kp_add, am_add, seed, scale, rate,
                h0):
        ctx.save_for_backward(q_u, q_v, k, v, p, kp_add, am_add)
        ctx.seed, ctx.scale, ctx.rate, ctx.h0 = seed, scale, rate, h0
        return relpos_attention_fwd_bf16(q_u, q_v, k, v, p, kp_add, am_add,
                                         scale, seed, rate, h0)

    @staticmethod
    def backward(ctx, do):
        grads = relpos_attention_bwd_bf16(*ctx.saved_tensors, do, ctx.scale,
                                          ctx.seed, ctx.rate, ctx.h0)
        return (*grads, None, None, None, None, None, None)


# ------------------------------------------------------------------ kernels
@functools.cache
def _fwd_kernel(entry="relpos_attention_fwd"):
    """A forward C entry of ``SOURCE``: the f32 kernel, or the bf16
    forward's resident (``relpos_attention_fwd_bf16``) or long route
    (``relpos_attention_fwd_bf16_long``); one signature."""
    fn = getattr(_build.load(SOURCE), entry)
    fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_uint, ctypes.c_float,
                                           ctypes.c_void_p] + \
        [ctypes.c_int] * 4 + [ctypes.c_float, ctypes.c_void_p, ctypes.c_int]
    fn.restype = ctypes.c_int
    return fn


@functools.cache
def _mask_kernel():
    fn = _build.load(SOURCE).relpos_dropout_mask
    fn.argtypes = [ctypes.c_void_p, ctypes.c_uint, ctypes.c_void_p] + \
        [ctypes.c_int] * 3 + [ctypes.c_void_p, ctypes.c_int]
    fn.restype = ctypes.c_int
    return fn


@functools.cache
def _bwd_kernel():
    fn = _build.load(BWD_SOURCE).relpos_attention_bwd
    fn.argtypes = [ctypes.c_void_p] * 11 + [ctypes.c_uint, ctypes.c_float] + \
        [ctypes.c_void_p] * 7 + [ctypes.c_int] * 4 + [
            ctypes.c_float, ctypes.c_void_p, ctypes.c_int]
    fn.restype = ctypes.c_int
    return fn


@functools.cache
def _bwd_kernel_bf16(entry="relpos_attention_bwd_bf16"):
    """The bf16 backward's resident (``relpos_attention_bwd_bf16``) or
    long route (``relpos_attention_bwd_bf16_long``); one signature."""
    fn = getattr(_build.load(BWD_SOURCE), entry)
    fn.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_uint, ctypes.c_float] + \
        [ctypes.c_void_p] * 7 + [ctypes.c_int] * 4 + [
            ctypes.c_float, ctypes.c_void_p, ctypes.c_int]
    fn.restype = ctypes.c_int
    return fn


@functools.cache
def _bwd_scratch_floats(entry="relpos_attention_bwd_dp_part_floats"):
    """A scratch size query of ``BWD_SOURCE`` (B, H, T, Dh -> floats): dp's
    partials, or the bf16 resident route's whole scratch
    (``relpos_attention_bwd_bf16_scratch_floats``)."""
    fn = getattr(_build.load(BWD_SOURCE), entry)
    fn.argtypes = [ctypes.c_int] * 4
    fn.restype = ctypes.c_longlong
    return fn


def _check(q_u, q_v, k, v, p, kp_add, am_add, do=None):
    B, H, T, Dh = q_u.shape
    expected = {"q_u": (B, H, T, Dh), "q_v": (B, H, T, Dh),
                "k": (B, H, T, Dh), "v": (B, H, T, Dh),
                "p": (H, 2 * T - 1, Dh), "kp_add": (B, T), "am_add": (T, T),
                "grad_out": (B, H, T, Dh)}
    tensors = {"q_u": q_u, "q_v": q_v, "k": k, "v": v, "p": p,
               "kp_add": kp_add, "am_add": am_add}
    if do is not None:
        tensors["grad_out"] = do
    if q_u.dtype not in DTYPES:
        raise TypeError(f"q_u must be float32 or bfloat16, got {q_u.dtype}")
    for name, t in tensors.items():
        if t.device != q_u.device:
            raise ValueError(f"{name} is on {t.device}, q_u on {q_u.device}")
        want = torch.float32 if name in ("kp_add", "am_add") else q_u.dtype
        if t.dtype != want:
            raise TypeError(f"{name} must be {want}, got {t.dtype}")
        if tuple(t.shape) != expected[name]:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, "
                             f"expected {expected[name]}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if not 1 <= Dh <= MAX_HEAD_DIM:
        raise ValueError(f"head dim {Dh} outside 1..{MAX_HEAD_DIM}")


def _stream(device):
    return torch.cuda.current_stream(device).cuda_stream


def _dropout_args(rate):
    """(u32 threshold, keep scale) of the kernels' dropout."""
    if rate <= 0.0:
        return 0, 1.0
    if rate >= 1.0:
        raise ValueError(f"dropout rate {rate} must be below 1")
    return dropout_threshold(rate), 1.0 / (1.0 - rate)


def _launch_fwd(q_u, q_v, k, v, p, kp_add, am_add, seed, scale, rate,
                want_stats, h0=0):
    _check(q_u, q_v, k, v, p, kp_add, am_add)
    B, H, T, Dh = q_u.shape
    thresh, keep_scale = _dropout_args(rate)
    seed_t = _seed_tensor(seed, q_u.device) if rate > 0.0 else None
    out = torch.empty_like(q_u)
    stats = torch.empty(B, H, T, 2, device=q_u.device) if want_stats \
        else None
    bf16 = q_u.dtype == torch.bfloat16
    long_route = bf16 and bf16_fwd_route(T, Dh) == "long"
    name = "relpos_attention_fwd" + ("_bf16_long" if long_route else
                                     "_bf16" if bf16 else "")
    with torch.cuda.device(q_u.device):
        err = _fwd_kernel(name)(
            q_u.data_ptr(), q_v.data_ptr(), k.data_ptr(), v.data_ptr(),
            p.data_ptr(), kp_add.data_ptr(), am_add.data_ptr(),
            out.data_ptr(), 0 if stats is None else stats.data_ptr(),
            thresh, keep_scale, 0 if seed_t is None else seed_t.data_ptr(),
            B, H, T, Dh, float(scale), _stream(q_u.device), int(h0))
    _build.check_launch(err, name)
    global launches, bf16_launches, bf16_long_launches
    if not bf16:
        launches += 1
    elif long_route:
        bf16_long_launches += 1
    else:
        bf16_launches += 1
    return out, stats, seed_t


def _launch_bwd(q_u, q_v, k, v, p, kp_add, am_add, out, stats, do, seed_t,
                scale, rate, h0=0):
    _check(q_u, q_v, k, v, p, kp_add, am_add, do)
    B, H, T, Dh = q_u.shape
    thresh, keep_scale = _dropout_args(rate)
    dqu, dqv, dk, dv = (torch.empty_like(q_u) for _ in range(4))
    dp = torch.empty_like(p)
    delta = torch.empty(B, H, T, device=q_u.device)
    bf16 = q_u.dtype == torch.bfloat16
    resident = bf16 and bf16_bwd_route(T, Dh) == "resident"
    # dp's partials, one per (b, h, tile diagonal), and on the bf16
    # resident route dS and Pd after them; the kernel sizes them
    query = "relpos_attention_bwd_" + ("bf16_scratch_floats" if resident
                                       else "dp_part_floats")
    dp_part = torch.empty(_bwd_scratch_floats(query)(B, H, T, Dh),
                          device=p.device)
    if bf16:
        name = "relpos_attention_bwd_bf16" + ("" if resident else "_long")
        with torch.cuda.device(q_u.device):
            err = _bwd_kernel_bf16(name)(
                q_u.data_ptr(), q_v.data_ptr(), k.data_ptr(), v.data_ptr(),
                p.data_ptr(), kp_add.data_ptr(), am_add.data_ptr(),
                stats.data_ptr(), do.data_ptr(),
                0 if seed_t is None else seed_t.data_ptr(), thresh,
                keep_scale, delta.data_ptr(), dqu.data_ptr(), dqv.data_ptr(),
                dk.data_ptr(), dv.data_ptr(), dp_part.data_ptr(),
                dp.data_ptr(), B, H, T, Dh, float(scale), _stream(q_u.device),
                int(h0))
        _build.check_launch(err, name)
        global bf16_bwd_launches, bf16_bwd_long_launches
        if resident:
            bf16_bwd_launches += 1
        else:
            bf16_bwd_long_launches += 1
        return dqu, dqv, dk, dv, dp
    with torch.cuda.device(q_u.device):
        err = _bwd_kernel()(
            q_u.data_ptr(), q_v.data_ptr(), k.data_ptr(), v.data_ptr(),
            p.data_ptr(), kp_add.data_ptr(), am_add.data_ptr(),
            out.data_ptr(), stats.data_ptr(), do.data_ptr(),
            0 if seed_t is None else seed_t.data_ptr(), thresh, keep_scale,
            delta.data_ptr(), dqu.data_ptr(), dqv.data_ptr(), dk.data_ptr(),
            dv.data_ptr(), dp_part.data_ptr(), dp.data_ptr(),
            B, H, T, Dh, float(scale), _stream(q_u.device), int(h0))
    _build.check_launch(err, "relpos_attention_bwd")
    global bwd_launches
    bwd_launches += 1
    return dqu, dqv, dk, dv, dp


def dropout_mask_cuda(seed, B, H, T, rate, device, h0=0):
    """(B, H, T, T) bool keep mask as the CUDA kernels draw it, the heads
    counted from ``h0`` (a test hook: it compares the kernels' Philox
    with ``philox_keep_mask``)."""
    seed_t = _seed_tensor(seed, device)
    mask = torch.empty(B, H, T, T, dtype=torch.uint8, device=device)
    with torch.cuda.device(device):
        err = _mask_kernel()(seed_t.data_ptr(), dropout_threshold(rate),
                             mask.data_ptr(), B, H, T, _stream(device),
                             int(h0))
    _build.check_launch(err, "relpos_dropout_mask")
    return mask.bool()


class _FusedRelPosAttention(torch.autograd.Function):
    """The forward and backward kernels as one differentiable op; the
    masks, the seed, ``scale`` and ``rate`` get no gradient."""

    @staticmethod
    def forward(ctx, q_u, q_v, k, v, p, kp_add, am_add, seed, scale, rate,
                h0):
        out, stats, seed_t = _launch_fwd(q_u, q_v, k, v, p, kp_add, am_add,
                                         seed, scale, rate, want_stats=True,
                                         h0=h0)
        ctx.save_for_backward(q_u, q_v, k, v, p, kp_add, am_add, out, stats)
        ctx.seed_t, ctx.scale, ctx.rate, ctx.h0 = seed_t, scale, rate, h0
        return out

    @staticmethod
    def backward(ctx, do):
        # saved_tensors read once: a checkpoint (remat) unpacks each
        # saved tensor only once
        saved = ctx.saved_tensors
        # the JAX custom VJP casts the output gradient to q's dtype
        do = do.to(saved[0].dtype).contiguous()
        grads = _launch_bwd(*saved, do, ctx.seed_t, ctx.scale, ctx.rate,
                            ctx.h0)
        return (*grads, None, None, None, None, None, None)


def fused_relpos_attention(q_u, q_v, k, v, p, kp_add, am_add, seed, scale,
                           rate, h0=0):
    """Fused rel-pos attention, mirroring the JAX signature.

    ``seed`` (int or integer tensor) keys the dropout mask, which the
    backward regenerates; ``rate`` is the dropout rate on the
    probabilities (0 in eval); ``h0`` is the first head's index among
    the model's (a tensor-parallel rank's heads), which the mask counts
    from. Returns (B, H, T, Dh) in q_u's dtype: f32 or bf16 operands
    (the masks f32), each to its own kernels.
    """
    if q_u.device.type == "cpu":
        return relpos_attention_reference(q_u, q_v, k, v, p, kp_add, am_add,
                                          scale, seed, rate, h0)
    if q_u.device.type != "cuda":
        raise ValueError(f"unsupported device {q_u.device}")
    needs_grad = torch.is_grad_enabled() and any(
        t.requires_grad for t in (q_u, q_v, k, v, p))
    if needs_grad:
        return _FusedRelPosAttention.apply(q_u, q_v, k, v, p, kp_add, am_add,
                                           seed, scale, rate, h0)
    out, _, _ = _launch_fwd(q_u, q_v, k, v, p, kp_add, am_add, seed, scale,
                            rate, want_stats=False, h0=h0)
    return out
