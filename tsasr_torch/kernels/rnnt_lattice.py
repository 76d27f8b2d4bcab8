"""RNN-T lattice solve: CUDA kernels, plain version, wrapper.

Counterpart of the JAX package's ``ops/rnnt_loss_pallas.py::_pallas_lattice``:
(B, T, U+1) blank and label log-prob lattices plus the lengths go in,
the per-utterance loss and the gradients w.r.t. both lattices come out.
``csrc/rnnt_lattice.cu`` replaces its three Pallas kernels:

- ``variant="resident"`` (``_rnnt_kernel``): one kernel, both passes as
  warp-level row chains (the log-sum-exp as (max, scaled sum) pairs),
  the utterance's alpha lattice in shared memory;
- ``variant="slab"`` (``_rnnt_alpha_slab_kernel`` +
  ``_rnnt_beta_slab_kernel``): an alpha kernel that writes alpha and logZ
  to device memory, then a beta + gradient kernel that reads them back,
  the resident kernel's alpha and beta row chains each on its own. Where
  the two variants' chains take the same K (``alpha_slab_cols``,
  ``resident_cols``), they run the same arithmetic, so their losses agree
  bit for bit; elsewhere within the lattice's f32 tolerance.

``tests/test_torch_lattice_chain.py`` mirrors the row chains' tiling on
the CPU. ``variant="auto"`` picks resident when ``resident_fits(T, U+1)``.
``rnnt_lattice_reference`` is the same row scans in plain PyTorch, made
of ``rnnt_alpha_reference`` and ``rnnt_beta_reference``, the plain
versions of the two slab kernels. The
wrapper ``rnnt_lattice`` takes it only for tensors on the CPU; on CUDA it
launches the kernels or raises. ``resident_launches``,
``alpha_slab_launches`` and ``beta_slab_launches`` count launches.
"""

import ctypes
import functools

import torch

from tsasr_torch.kernels import _build

SOURCE = "rnnt_lattice"
NEG = -1e30
# Shared memory a block may ask for on an H100, and the row chains'
# constants (csrc/rnnt_lattice.cu: kSlots, kResidentHeader)
MAX_SMEM_BYTES = 227 * 1024
SLOTS = 6
RESIDENT_HEADER_FLOATS = 64

resident_launches = 0
alpha_slab_launches = 0
beta_slab_launches = 0


def _beta_ring_floats(U1, chunk):
    """The beta ring at its largest over the chunks a row can take."""
    return max((-(-(SLOTS - 1) // r) + 2) * r * chunk
               for r in range(1, -(-U1 // chunk) + 1))


def _resident_smem_at(T, U1, K):
    chunk = 32 * K
    return 4 * (RESIDENT_HEADER_FLOATS + SLOTS * 3 * chunk
                + T * (-(-U1 // 4) * 4) + _beta_ring_floats(U1, chunk))


def alpha_slab_cols(U1):
    """Columns a chain lane owns in the alpha slab kernel (its C++
    ``alpha_slab_cols``): the least of 4, 8, 16, 32 whose chunk of 32 K
    columns holds a row; 32 for wider rows, which take several chunks.
    Its shared memory does not grow with T or U+1."""
    return 4 if U1 <= 128 else 8 if U1 <= 256 else 16 if U1 <= 512 else 32


def resident_cols(T, U1):
    """Columns a chain lane owns in the resident kernel: as the alpha
    slab's, but 8 when 16 or 32 would not fit."""
    K = alpha_slab_cols(U1)
    return K if K <= 8 or _resident_smem_at(T, U1, K) <= MAX_SMEM_BYTES \
        else 8


def resident_smem(T, U1):
    """Bytes of shared memory the resident kernel asks for (its C entry
    ``rnnt_lattice_resident_smem``): mbarriers and logZ, a ring of 6
    slots of 3 chunks, alpha (T rows of U+1 rounded up to 4 floats) and
    the beta ring."""
    return _resident_smem_at(T, U1, resident_cols(T, U1))


def resident_fits(T, U1):
    """True when the resident kernel's shared memory fits a block's
    227 KB."""
    return resident_smem(T, U1) <= MAX_SMEM_BYTES


# ------------------------------------------------------------ plain version
def _logaddexp(a, b):
    """log(exp(a) + exp(b)), NEG when both are <= NEG/2 (the JAX guard)."""
    mx = torch.maximum(a, b)
    mx_safe = torch.clamp(mx, min=NEG / 2)
    return torch.where(mx <= NEG / 2, NEG, mx_safe + torch.log1p(
        torch.exp(torch.minimum(a, b) - mx_safe)))


def _logcumsumexp(x):
    out = torch.logcumsumexp(x, dim=-1)
    return torch.where(out <= NEG / 2, NEG, out)


def rnnt_alpha_reference(lpb, lpl, t_lens, u_lens):
    """The alpha slab kernel's row scan in plain PyTorch, one row of every
    utterance at a time: (alpha (B, T, U+1), logZ (B,)). Cells outside an
    utterance's lattice hold what the scan carries there; no kernel
    reads them."""
    B, T, U1 = lpb.shape
    col = torch.arange(U1, device=lpb.device)[None]
    Tl = t_lens.long()[:, None]
    Ul = u_lens.long()[:, None]
    neg = torch.full((B, U1), NEG, dtype=lpb.dtype, device=lpb.device)

    alphas, logz = [], neg[:, :1]
    row = neg
    for t in range(T):
        p = torch.where(col < Ul, lpl[:, t], 0.0)
        cum_p = torch.cumsum(p, dim=-1) - p
        c = torch.where(col == 0, 0.0, neg) if t == 0 else row + lpb[:, t - 1]
        c = torch.where(col <= Ul, c, NEG)
        row = cum_p + _logcumsumexp(c - cum_p)
        alphas.append(row)
        terminal = (row + lpb[:, t]).gather(1, Ul)
        logz = torch.where(Tl - 1 == t, terminal, logz)
    return torch.stack(alphas, dim=1), logz[:, 0]


def rnnt_beta_reference(lpb, lpl, t_lens, u_lens, alpha, logz):
    """The beta slab kernel's sweep in plain PyTorch: the beta rows from
    the last frame down and the gradients (dlpb, dlpl), each (B, T, U+1),
    from alpha and logZ; 0 outside each utterance's lattice. Only the
    cells inside it are read from ``alpha``."""
    B, T, U1 = lpb.shape
    col = torch.arange(U1, device=lpb.device)[None]
    Tl = t_lens.long()[:, None]
    Ul = u_lens.long()[:, None]
    neg = torch.full((B, U1), NEG, dtype=lpb.dtype, device=lpb.device)
    logz = logz[:, None]

    dlpb = torch.empty_like(lpb)
    dlpl = torch.empty_like(lpl)
    beta_next = neg
    for t in reversed(range(T)):
        lpb_t, lpl_t = lpb[:, t], lpl[:, t]
        last = Tl - 1 == t
        d = torch.where(last, torch.where(col == Ul, lpb_t, NEG),
                        beta_next + lpb_t)
        d = torch.where(col <= Ul, d, NEG)
        p = torch.where(col < Ul, lpl_t, 0.0)
        cs = torch.cumsum(p, dim=-1)
        suf_p = cs[:, -1:] - cs + p
        beta = suf_p + _logcumsumexp((d - suf_p).flip(-1)).flip(-1)
        beta = torch.where(col <= Ul, beta, NEG)
        valid = t < Tl
        beta_t1 = torch.where(last, torch.where(col == Ul, 0.0, NEG),
                              beta_next)
        dlpb[:, t] = -torch.exp(torch.where(
            valid & (col <= Ul), alpha[:, t] + lpb_t + beta_t1 - logz, NEG))
        beta_u1 = torch.cat([beta[:, 1:], neg[:, :1]], dim=1)
        dlpl[:, t] = -torch.exp(torch.where(
            valid & (col < Ul), alpha[:, t] + lpl_t + beta_u1 - logz, NEG))
        beta_next = torch.where(valid, beta, beta_next)
    return dlpb, dlpl


def rnnt_lattice_reference(lpb, lpl, t_lens, u_lens):
    """The kernels' row scans in plain PyTorch, one row of every
    utterance at a time: (loss (B,), dlpb, dlpl (B, T, U+1))."""
    alpha, logz = rnnt_alpha_reference(lpb, lpl, t_lens, u_lens)
    dlpb, dlpl = rnnt_beta_reference(lpb, lpl, t_lens, u_lens, alpha, logz)
    return -logz, dlpb, dlpl


# ------------------------------------------------------------------ kernels
@functools.cache
def _kernels():
    lib = _build.load(SOURCE)
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    fns = {"resident": lib.rnnt_lattice_resident,
           "alpha": lib.rnnt_lattice_alpha_slab,
           "beta": lib.rnnt_lattice_beta_slab}
    fns["resident"].argtypes = [ptr] * 7 + [i32] * 3 + [ptr]
    fns["alpha"].argtypes = [ptr] * 7 + [i32] * 3 + [ptr]
    fns["beta"].argtypes = [ptr] * 8 + [i32] * 3 + [ptr]
    for fn in fns.values():
        fn.restype = ctypes.c_int
    fns["resident_smem"] = lib.rnnt_lattice_resident_smem
    fns["resident_smem"].argtypes = [i32, i32]
    fns["resident_smem"].restype = ctypes.c_longlong
    fns["alpha_slab_cols"] = lib.rnnt_lattice_alpha_slab_cols
    fns["alpha_slab_cols"].argtypes = [i32]
    fns["alpha_slab_cols"].restype = ctypes.c_int
    return fns


def _check(lpb, lpl, t_lens, u_lens):
    if lpb.dim() != 3:
        raise ValueError(f"lpb must be (B, T, U+1), got {tuple(lpb.shape)}")
    B = lpb.shape[0]
    for name, t, dtype, shape in (
            ("lpb", lpb, torch.float32, tuple(lpb.shape)),
            ("lpl", lpl, torch.float32, tuple(lpb.shape)),
            ("t_lens", t_lens, torch.int32, (B,)),
            ("u_lens", u_lens, torch.int32, (B,))):
        if t.device != lpb.device:
            raise ValueError(f"{name} is on {t.device}, lpb on {lpb.device}")
        if t.dtype != dtype:
            raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, "
                             f"expected {shape}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def rnnt_lattice(lpb, lpl, t_lens, u_lens, variant="auto"):
    """(B, T, U+1) blank/label log-probs, int32 lengths -> (loss (B,),
    dlpb, dlpl), like the JAX ``_pallas_lattice``. ``variant`` is
    "auto", "resident" or "slab" (CUDA only; the CPU takes the plain
    version)."""
    if variant not in ("auto", "resident", "slab"):
        raise ValueError(f"unknown variant {variant!r}")
    if lpb.device.type == "cpu":
        return rnnt_lattice_reference(lpb, lpl, t_lens, u_lens)
    if lpb.device.type != "cuda":
        raise ValueError(f"unsupported device {lpb.device}")
    _check(lpb, lpl, t_lens, u_lens)
    B, T, U1 = lpb.shape
    if variant == "auto":
        variant = "resident" if resident_fits(T, U1) else "slab"
    elif variant == "resident" and not resident_fits(T, U1):
        raise ValueError(f"a ({T}, {U1}) lattice does not fit the resident "
                         "kernel's shared memory")
    loss = torch.empty(B, device=lpb.device)
    dlpb = torch.empty_like(lpb)
    dlpl = torch.empty_like(lpl)
    fns = _kernels()
    ptrs = (lpb.data_ptr(), lpl.data_ptr(), t_lens.data_ptr(),
            u_lens.data_ptr())
    global resident_launches, alpha_slab_launches, beta_slab_launches
    with torch.cuda.device(lpb.device):
        stream = torch.cuda.current_stream(lpb.device).cuda_stream
        if variant == "resident":
            err = fns["resident"](*ptrs, loss.data_ptr(), dlpb.data_ptr(),
                                  dlpl.data_ptr(), B, T, U1, stream)
            _build.check_launch(err, "rnnt_lattice_resident")
            resident_launches += 1
            return loss, dlpb, dlpl
        alpha = torch.empty_like(lpb)
        logz = torch.empty(B, device=lpb.device)
        err = fns["alpha"](*ptrs, alpha.data_ptr(), logz.data_ptr(),
                           loss.data_ptr(), B, T, U1, stream)
        _build.check_launch(err, "rnnt_lattice_alpha_slab")
        alpha_slab_launches += 1
        err = fns["beta"](*ptrs, alpha.data_ptr(), logz.data_ptr(),
                          dlpb.data_ptr(), dlpl.data_ptr(), B, T, U1, stream)
        _build.check_launch(err, "rnnt_lattice_beta_slab")
        beta_slab_launches += 1
    return loss, dlpb, dlpl
