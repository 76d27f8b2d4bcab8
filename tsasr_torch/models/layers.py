"""Linear, LayerNorm and convolution layers with a compute dtype.

Each is the torch layer (same parameters, same ``state_dict`` keys, same
initialisation) with flax's ``dtype`` semantics added: in a bf16 model
the layer casts its f32 parameters and its input to bf16 at use and
returns bf16 (``utils.precision.cast``); in an f32 model it is the torch
layer unchanged. The LayerNorm computes its statistics and its affine in
f32 and rounds the result to bf16 once, as flax's ``LayerNorm(dtype=
bfloat16)`` does (``_compute_stats`` promotes to f32; flax takes the
variance as E[x^2] - E[x]^2 where torch takes E[(x - E[x])^2], which
differ at f32 rounding, below one bf16 rounding of the output).
"""

import torch
import torch.nn.functional as F
from torch import nn

from tsasr_torch.utils.precision import cast


def linear(x, weight, bias=None, compute_dtype=torch.float32):
    """``F.linear`` in the compute dtype: a ``Linear``'s forward on other
    weights (a tensor-parallel rank's shard or slice)."""
    dt = compute_dtype
    return F.linear(cast(x, dt), cast(weight, dt), cast(bias, dt))


class Linear(nn.Linear):
    def __init__(self, in_features, out_features, bias=True,
                 compute_dtype=torch.float32):
        super().__init__(in_features, out_features, bias)
        self.compute_dtype = compute_dtype

    def forward(self, x):
        dt = self.compute_dtype
        return F.linear(cast(x, dt), cast(self.weight, dt),
                        cast(self.bias, dt))


class LayerNorm(nn.LayerNorm):
    def __init__(self, normalized_shape, eps=1e-5,
                 compute_dtype=torch.float32):
        super().__init__(normalized_shape, eps=eps)
        self.compute_dtype = compute_dtype

    def forward(self, x):
        if self.compute_dtype == torch.float32:
            return super().forward(x)
        y = F.layer_norm(x.float(), self.normalized_shape, self.weight,
                         self.bias, self.eps)
        return y.to(self.compute_dtype)


class Conv1d(nn.Conv1d):
    def __init__(self, *args, compute_dtype=torch.float32, **kwargs):
        super().__init__(*args, **kwargs)
        self.compute_dtype = compute_dtype

    def forward(self, x):
        dt = self.compute_dtype
        return self._conv_forward(cast(x, dt), cast(self.weight, dt),
                                  cast(self.bias, dt))


class Conv2d(nn.Conv2d):
    def __init__(self, *args, compute_dtype=torch.float32, **kwargs):
        super().__init__(*args, **kwargs)
        self.compute_dtype = compute_dtype

    def forward(self, x):
        dt = self.compute_dtype
        return self._conv_forward(cast(x, dt), cast(self.weight, dt),
                                  cast(self.bias, dt))
