"""RNN language model for shallow fusion in the transducer beams.

Counterpart of the JAX package's ``models/lm.py``: Embedding -> LSTM ->
Dense + leaky_relu (0.01) -> output head, with one decode ``step`` and
the ``make_lm_step_fn`` adapter both beam searchers consume. On every
non-blank expansion a hypothesis gains ``lm_weight * log p_lm(token)``
and the LM state advances with the emitted token.

The JAX package saves the LM as flax msgpack, which the card's machine
cannot read (no flax, no msgpack). The port's checkpoint is its own:
``torch.save({"config": dict, "model": state_dict})``
(``save_lm_checkpoint`` / ``load_lm_checkpoint``);
``convert.lm_params_from_flax`` carries a JAX RNN-LM across. The
teacher-forced ``forward`` runs without dropout: training the LM
(the JAX package's ``tools/train_lm.py``) is not ported yet.
"""

import math
from dataclasses import asdict, dataclass

import torch
import torch.nn.functional as F
from torch import nn

from tsasr_torch.device import resolve_device
from tsasr_torch.models.rnn import LSTM


@dataclass(frozen=True)
class RNNLMConfig:
    vocab_size: int = 29
    embedding_dim: int = 128
    hidden_size: int = 256
    num_layers: int = 2
    dnn_neurons: int = 256
    dropout: float = 0.15


class RNNLM(nn.Module):
    """Embedding -> LSTM -> Dense -> output logits over the vocab."""

    def __init__(self, config=None):
        super().__init__()
        c = config or RNNLMConfig()
        self.config = c
        self.embedding = nn.Embedding(c.vocab_size, c.embedding_dim)
        self.rnn = LSTM(c.embedding_dim, c.hidden_size, c.num_layers)
        self.dnn = nn.Linear(c.hidden_size, c.dnn_neurons)
        self.out = nn.Linear(c.dnn_neurons, c.vocab_size)

    def _head(self, h):
        return self.out(F.leaky_relu(self.dnn(h), 0.01))

    def forward(self, tokens):
        """Teacher-forced forward: (B, U) tokens -> (B, U, V) logits for
        the NEXT token at each position."""
        h, _ = self.rnn(self.embedding(tokens))
        return self._head(h)

    def step(self, token, state):
        """One decode step: (B,) token -> ((B, V) log-probs, state)."""
        h, state = self.rnn.step(self.embedding(token), state)
        return torch.log_softmax(self._head(h), dim=-1), state

    def initial_state(self, batch_size):
        return self.rnn.initial_state(batch_size,
                                      self.embedding.weight.device)

    @torch.no_grad()
    def init_weights(self, seed=0):
        """Random weights from a seeded CPU generator, the same on every
        device: normal embeddings, xavier-normal dense kernels, zero
        biases, LSTM uniform(+-1/sqrt(H))."""
        g = torch.Generator().manual_seed(seed)
        self.embedding.weight.copy_(
            torch.randn(self.embedding.weight.shape, generator=g))
        for linear in (self.dnn, self.out):
            weight = torch.empty(linear.weight.shape)
            nn.init.xavier_normal_(weight, generator=g)
            linear.weight.copy_(weight)
            linear.bias.zero_()
        bound = 1.0 / math.sqrt(self.rnn.hidden_size)
        for p in self.rnn.parameters():
            p.copy_(torch.empty(p.shape).uniform_(-bound, bound,
                                                  generator=g))
        return self


def make_lm_step_fn(model):
    """-> ``lm_step_fn(tokens (N,), state) -> (log_probs (N, V), state)``
    with ``state=None`` meaning the zero initial state (the exact beam
    calls it with one int token per hypothesis; the batched beam passes
    (N,) tokens and real states)."""
    device = model.embedding.weight.device

    @torch.inference_mode()
    def lm_step_fn(tokens, state):
        arr = torch.as_tensor(tokens, dtype=torch.long, device=device)
        scalar = arr.ndim == 0
        batch = arr[None] if scalar else arr
        if state is None:
            state = model.initial_state(batch.shape[0])
        log_probs, state = model.step(batch, state)
        return (log_probs[0] if scalar else log_probs), state

    return lm_step_fn


def lm_initial_state(model, batch_size):
    return model.initial_state(batch_size)


def save_lm_checkpoint(model, path):
    """The port's RNN-LM checkpoint: its config and its state_dict."""
    torch.save({"config": asdict(model.config),
                "model": {k: v.detach().cpu()
                          for k, v in model.state_dict().items()}}, path)


def load_lm_checkpoint(path, device="cuda"):
    """A ``save_lm_checkpoint`` file -> an ``RNNLM`` in eval mode on
    ``device``."""
    payload = torch.load(path, map_location="cpu", weights_only=True)
    model = RNNLM(RNNLMConfig(**payload["config"]))
    model.load_state_dict(payload["model"])
    return model.to(resolve_device(device)).eval()
