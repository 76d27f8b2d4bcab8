"""The port's transducer beams against the JAX package's, and against
each other on synthetic models whose best path is known.

- the batched beam (``BatchedBeamSearcher``, beam 1 and 4) and the exact
  beam (``TransducerBeamSearcher``) give the JAX searchers' hypotheses
  on the same encoder output and weights (three and two utterances of
  variable length): identical tokens, normalized scores within 1e-5
  (f32 on both sides, one LSTM step and one joint per expansion);
- on the synthetic models of the JAX package's ``tests/test_decoding.py``
  the batched beam finds the peaked model's path (as greedy and the
  exact beam do), recovers delayed evidence greedy misses, respects
  variable lengths, and the exact beam terminates on a near-uniform
  random model.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_helpers import (SCORE_ATOL, assert_same_beams,
                               decoder_models, encoder_output)
from tsasr_torch.decoding import (BatchedBeamSearcher,
                                  TransducerBeamSearcher,
                                  TransducerGreedySearcher,
                                  beam_search_batched, greedy_decode)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize("beam", [1, 4])
def test_batched_beam_matches_jax(beam):
    from tsasr_tpu.decoding import BatchedBeamSearcher as JaxBatched
    jax_model, params, model = decoder_models()
    enc, rel = encoder_output()
    want = JaxBatched(jax_model, params, beam_size=beam, nbest=beam)
    got = BatchedBeamSearcher(model, beam_size=beam, nbest=beam)
    assert_same_beams(
        got.decode(torch.from_numpy(enc), torch.from_numpy(rel)),
        want._jitted(params, jnp.asarray(enc), jnp.asarray(rel)))
    hyps, score, nbest, nbest_scores = got(torch.from_numpy(enc),
                                           torch.from_numpy(rel))
    w_hyps, w_score, w_nbest, w_nbest_scores = want(jnp.asarray(enc),
                                                    jnp.asarray(rel))
    assert hyps == w_hyps and nbest == w_nbest
    assert all(hyps)
    np.testing.assert_allclose(score, w_score, rtol=1e-5)
    np.testing.assert_allclose(nbest_scores, w_nbest_scores, rtol=0,
                               atol=SCORE_ATOL)


def test_exact_beam_matches_jax():
    from tsasr_tpu.decoding import TransducerBeamSearcher as JaxExact
    jax_model, params, model = decoder_models()
    enc, rel = encoder_output(batch=2, frames=6)
    want = JaxExact(jax_model, params, 0, beam_size=4, nbest=4)
    got = TransducerBeamSearcher(model, 0, beam_size=4, nbest=4)
    hyps, score, nbest, nbest_scores = got(torch.from_numpy(enc),
                                           torch.from_numpy(rel))
    w_hyps, w_score, w_nbest, w_nbest_scores = want(jnp.asarray(enc),
                                                    jnp.asarray(rel))
    assert hyps == w_hyps and nbest == w_nbest
    assert [len(n) for n in nbest] == [4, 4]
    for a, b in zip(nbest_scores, w_nbest_scores):
        np.testing.assert_allclose(a, b, rtol=0, atol=SCORE_ATOL)
    np.testing.assert_allclose(score, w_score, rtol=1e-5)


def test_exact_beam_below_two_is_greedy():
    _, _, model = decoder_models()
    enc, rel = (torch.from_numpy(x) for x in encoder_output())
    got = TransducerBeamSearcher(model, 0, beam_size=1)(enc, rel)
    want = TransducerGreedySearcher(model, 0)(enc, rel)
    assert got[0] == want[0] and got[1] == want[1]


# --- synthetic models (the JAX package's tests/test_decoding.py) --------
def stateless_model():
    """The joint's output is the frame's row of log-probs (enc)."""

    def predict_step(tokens, state):
        return torch.zeros(tokens.shape[0], 4), state

    def joint_step(enc_t, dec):
        return enc_t

    return predict_step, joint_step


def counting_model(target, emit_frames, v=5, peak=0.0, off=-8.0):
    """The prediction state counts emissions; the joint peaks at
    ``target[count]`` only at frame ``emit_frames[count]``, else at
    blank. The state is one (1, N, 1) leaf, like the LSTM's (L, N, H)."""
    target = torch.tensor(target)
    emit_frames = torch.tensor(emit_frames, dtype=torch.float32)

    def predict_step(tokens, state):
        count = state[0][0, :, 0] + (tokens != 0).float()
        return count[:, None], (count[None, :, None],)

    def joint_step(enc_t, dec):
        frame = enc_t[:, 0]
        count = dec[:, 0].long().clamp(0, len(target) - 1)
        done = dec[:, 0] >= len(target)
        should_emit = (frame == emit_frames[count]) & ~done
        logp = torch.full((frame.shape[0], v), off)
        logp[:, 0] = torch.where(should_emit, off, peak)
        rows = torch.arange(frame.shape[0])
        logp[rows, target[count]] = torch.where(should_emit, peak, off)
        return logp

    def initial_state(n):
        return (torch.zeros(1, n, 1),)

    return predict_step, joint_step, initial_state


def synthetic_exact(predict, joint, initial_state, beam_size):
    """The exact beam over a synthetic model: its device calls replaced
    by the model's."""
    searcher = TransducerBeamSearcher(None, 0, beam_size=beam_size, nbest=1)
    searcher._predict_step = \
        lambda token, state, device: predict(torch.tensor([token]), state)
    searcher._joint_log_probs = \
        lambda enc_t, dec: joint(enc_t[None], dec)[0].numpy()
    searcher._initial_state = lambda device: initial_state(1)
    return searcher


def test_batched_and_exact_find_the_peaked_models_path():
    target, frames = [2, 3, 1], [0, 2, 4]
    predict, joint, init = counting_model(target, frames)
    enc = torch.arange(5, dtype=torch.float32)[None, :, None]
    g_tokens, _, _ = greedy_decode(predict, joint, init(1), enc)
    assert [int(t) for t in g_tokens[0] if t != 0] == target
    tokens, lengths, _ = beam_search_batched(
        predict, joint, init(3), enc, blank=0, beam_size=3, max_symbols=8)
    assert tokens[0, 0, :lengths[0, 0]].tolist() == target
    hyps, _, _, _ = synthetic_exact(predict, joint, init, 3)(enc)
    assert hyps == [target]


def test_batched_beam_recovers_delayed_evidence():
    """Greedy trap: frame 0 slightly prefers token 1, but emitting
    poisons frame 1 where the clean path scores much better."""

    def predict_step(tokens, state):
        count = state[0][0, :, 0] + (tokens != 0).float()
        return count[:, None], (count[None, :, None],)

    def joint_step(enc_t, dec):
        n = enc_t.shape[0]
        first = enc_t[:, 0] < 0.5
        emitted = dec[:, 0] > 0
        f0 = torch.tensor([-0.8, -0.6, -3.0]).expand(n, 3)
        f1_clean = torch.tensor([-3.0, -3.0, -0.05]).expand(n, 3)
        f1_emitted = torch.tensor([-2.0, -4.0, -4.0]).expand(n, 3)
        f1 = torch.where(emitted[:, None], f1_emitted, f1_clean)
        return torch.where(first[:, None], f0, f1)

    enc = torch.tensor([[[0.0], [1.0]]])
    g_tokens, _, _ = greedy_decode(predict_step, joint_step,
                                   (torch.zeros(1, 1, 1),), enc)
    assert [int(t) for t in g_tokens[0] if t != 0] == [1]
    tokens, lengths, _ = beam_search_batched(
        predict_step, joint_step, (torch.zeros(1, 2, 1),), enc, blank=0,
        beam_size=2, max_symbols=4, max_expansions=1, expand_beam=10.0)
    assert tokens[0, 0, :lengths[0, 0]].tolist() == [2]


def test_batched_beam_variable_lengths_in_batch():
    table = torch.full((4, 3), -5.0)
    table[:, 1] = -0.01
    predict, joint = stateless_model()
    enc = torch.stack([table, table])
    _, lengths, _ = beam_search_batched(
        predict, joint, None, enc, rel_lengths=torch.tensor([1.0, 0.5]),
        blank=0, beam_size=2, max_symbols=8, max_expansions=1)
    assert lengths[:, 0].tolist() == [4, 2]


def test_exact_beam_terminates_on_uniform_model():
    """The safety valve keeps the A* loop from exploding on a
    near-uniform random model."""
    from tsasr_torch.models.transducer import (TSTransducer,
                                               TSTransducerConfig)
    model = TSTransducer(TSTransducerConfig(
        vocab_size=8, encoder_num_layers=1, d_model=32, nhead=4, d_ffn=64,
        joint_dim=48, decoder_neurons=24, dropout=0.0, injection_mode=None,
        use_speaker_encoder=False)).init_weights(seed=0).eval()
    feats = torch.from_numpy(np.random.default_rng(0).normal(
        size=(1, 20, 80)).astype(np.float32))
    with torch.no_grad():
        enc = model.encode(feats, torch.ones(1))
    hyps, _, _, _ = TransducerBeamSearcher(model, 0, beam_size=4,
                                           nbest=1)(enc, torch.ones(1))
    assert len(hyps) == 1
