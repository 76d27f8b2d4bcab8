"""The attention kernels at a tensor-parallel rank's heads, on the card.
A rank launches heads [h0, h0 + n) of the model's H with ``h0`` given,
and its dropout counts from h0: the mask kernel, the f32 and the bf16
forward and backward then equal, bit for bit, those heads of the whole
launch, and hold against their plain versions. Marked ``cuda``: they
skip without a GPU and run on one with ``python -m pytest
tests/test_torch_tensor_parallel_cuda.py --noconftest -m cuda``; the
module imports no JAX."""

import pytest
import torch

from tsasr_torch.kernels import relpos_attention as ra

pytestmark = pytest.mark.cuda

B, H, T, DH, RATE = 2, 4, 101, 64, 0.1


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (and nvcc to build the kernels)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.parametrize("h0,n", [(2, 2), (1, 1), (3, 1)])
def test_mask_kernel_from_h0_is_the_slice(cuda, h0, n):
    whole = ra.dropout_mask_cuda(99, B, H, T, RATE, cuda)
    part = ra.dropout_mask_cuda(99, B, n, T, RATE, cuda, h0=h0)
    assert torch.equal(part, whole[:, h0:h0 + n])
    assert torch.equal(part.cpu(), ra.philox_keep_mask(99, B, n, T, RATE,
                                                       h0=h0))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("h0,n", [(2, 2), (0, 2), (3, 1)])
def test_kernels_from_h0_are_the_slice(cuda, dtype, h0, n):
    """The forward and the five gradients of heads [h0, h0 + n) launched
    alone equal the whole launch's, bit for bit; against the plain
    version with h0 within 1e-4 (f32) or 2^-7 / 2^-6 (bf16) of max."""
    g = torch.Generator().manual_seed(h0 * 7 + n)
    qu, qv, k, v = (torch.randn(B, H, T, DH, generator=g) for _ in range(4))
    p = torch.randn(H, 2 * T - 1, DH, generator=g)
    lens = torch.tensor([T, T - 30])
    kp = torch.where(torch.arange(T)[None] < lens[:, None], 0.0, -1e9)
    am = torch.zeros(T, T)
    do = torch.randn(B, H, T, DH, generator=g)
    seed = torch.tensor([4321], device=cuda)
    sl = slice(h0, h0 + n)
    masks = [kp.to(cuda), am.to(cuda)]

    def run(fn, tensors, grad_out, first):
        leaves = [t.to(cuda, dtype).contiguous().requires_grad_()
                  for t in tensors]
        out = fn(*leaves, *masks, seed=seed, scale=0.0625, rate=RATE,
                 h0=first)
        grads = torch.autograd.grad(out, leaves,
                                    grad_out.to(cuda, dtype).contiguous())
        return [out.detach(), *grads]

    before = (ra.launches, ra.bwd_launches, ra.bf16_launches,
              ra.bf16_bwd_launches)
    whole = run(ra.fused_relpos_attention, [qu, qv, k, v, p], do, 0)
    part_in = [x[:, sl] for x in (qu, qv, k, v)] + [p[sl]]
    part = run(ra.fused_relpos_attention, part_in, do[:, sl], h0)
    plain = run(ra.relpos_attention_reference, part_in, do[:, sl], h0)
    torch.cuda.synchronize()
    after = (ra.launches, ra.bwd_launches, ra.bf16_launches,
             ra.bf16_bwd_launches)
    counted = [a - b for a, b in zip(after, before)]
    assert counted == ([2, 2, 0, 0] if dtype == torch.float32
                       else [0, 0, 2, 2])
    for i, (got, full, want) in enumerate(zip(part, whole, plain)):
        assert torch.equal(got, full[sl] if i == 5 else full[:, sl]), i
        tol = 1e-4 if dtype == torch.float32 else \
            (2.0 ** -7 if i == 0 else 2.0 ** -6)
        err = ((got.double() - want.double()).abs().max()
               / want.double().abs().max().clamp(min=1.0)).item()
        assert err <= tol, (i, err)
