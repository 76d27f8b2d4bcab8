"""Multi-layer LSTM with one fused bias per layer.

Counterpart of the JAX package's ``models/rnn.py::LSTM`` (``__call__``,
``step``, ``initial_state``). Gate order is torch's (i, f, g, o); the
state is ``(h, c)``, each (num_layers, B, H). The JAX package keeps one
bias per layer (torch's b_ih + b_hh), so this module does too, with
weights in torch's (4H, in) layout. ``dtype`` is the compute dtype: in
bf16 the input, the weights, the bias and the initial state are cast to
bf16 and the gates and the cell run in bf16, as the JAX module does.
"""

import torch
from torch import nn

from tsasr_torch.utils.precision import cast


def _lstm_cell(gates, c):
    i, f, g, o = gates.chunk(4, dim=-1)
    c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
    h = torch.sigmoid(o) * torch.tanh(c)
    return h, c


class LSTM(nn.Module):
    """Unidirectional LSTM over (B, U, F) sequences."""

    def __init__(self, in_features, hidden_size, num_layers=1,
                 dtype=torch.float32):
        super().__init__()
        self.hidden_size = hidden_size
        self.num_layers = num_layers
        self.dtype = dtype
        size = in_features
        for layer in range(num_layers):
            self.register_parameter(f"weight_ih_l{layer}", nn.Parameter(
                torch.zeros(4 * hidden_size, size)))
            self.register_parameter(f"weight_hh_l{layer}", nn.Parameter(
                torch.zeros(4 * hidden_size, hidden_size)))
            self.register_parameter(f"bias_l{layer}", nn.Parameter(
                torch.zeros(4 * hidden_size)))
            size = hidden_size

    def _weights(self, layer):
        return tuple(cast(getattr(self, f"{name}_l{layer}"), self.dtype)
                     for name in ("weight_ih", "weight_hh", "bias"))

    def initial_state(self, batch_size, device=None):
        shape = (self.num_layers, batch_size, self.hidden_size)
        # an f32 model keeps torch's default dtype (f64 in the card's f32
        # noise-floor check)
        dtype = None if self.dtype == torch.float32 else self.dtype
        return (torch.zeros(shape, device=device, dtype=dtype),
                torch.zeros(shape, device=device, dtype=dtype))

    def forward(self, x, initial_state=None):
        """Whole sequence: x (B, U, F) -> (out (B, U, H), (h, c))."""
        if initial_state is None:
            initial_state = self.initial_state(x.shape[0], x.device)
        h0, c0 = (cast(s, self.dtype) for s in initial_state)
        out = cast(x, self.dtype)
        h_fin, c_fin = [], []
        for layer in range(self.num_layers):
            w_ih, w_hh, b = self._weights(layer)
            x_proj = out @ w_ih.T + b             # all steps in one matmul
            h, c = h0[layer], c0[layer]
            ys = []
            for t in range(x_proj.shape[1]):
                h, c = _lstm_cell(x_proj[:, t] + h @ w_hh.T, c)
                ys.append(h)
            out = torch.stack(ys, dim=1)
            h_fin.append(h)
            c_fin.append(c)
        return out, (torch.stack(h_fin), torch.stack(c_fin))

    def step(self, x, state):
        """One step: x (B, F), state (h, c) -> (out (B, H), state)."""
        h_all, c_all = (cast(s, self.dtype) for s in state)
        out = cast(x, self.dtype)
        h_new, c_new = [], []
        for layer in range(self.num_layers):
            w_ih, w_hh, b = self._weights(layer)
            gates = out @ w_ih.T + b + h_all[layer] @ w_hh.T
            h, c = _lstm_cell(gates, c_all[layer])
            h_new.append(h)
            c_new.append(c)
            out = h
        return out, (torch.stack(h_new), torch.stack(c_new))
