"""The port's language models and shallow fusion against the JAX
package's.

- the n-gram modules are copies: counts, the trained backoff model, its
  ARPA text, ARPA read-back, perplexity, the ``train_ngram_lm`` tool's
  ARPA and the dense fusion table are identical to JAX's, bit for bit;
  the fused step's log-probs and context states too;
- the RNN-LM with flax weights carried over (``lm_params_from_flax``):
  teacher-forced logits and step log-probs within 1e-5; the port's
  checkpoint reloads the same model;
- fusion in both beams on the synthetic models of the JAX package's
  ``tests/test_lm_fusion.py`` gives the tokens those tests pin (a
  biased LM flips the decision, LM states ride the beam);
- both beams with each LM on a real predictor and joint give the JAX
  searchers' hypotheses: identical tokens, scores within 1e-5.
"""

import io
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_helpers import (DECODER_PIECES, SCORE_ATOL,
                                assert_same_beams, decoder_models,
                                encoder_output)
from tsasr_torch import lm as port_lm
from tsasr_torch.data.tokenizer import CharTokenizer
from tsasr_torch.decoding import (BatchedBeamSearcher,
                                  TransducerBeamSearcher,
                                  beam_search_batched)
from tsasr_torch.models.lm import (RNNLM, RNNLMConfig, load_lm_checkpoint,
                                   make_lm_step_fn, save_lm_checkpoint)
from tsasr_tpu import lm as jax_lm

ORDER = 3
LM_WEIGHT = 0.5


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def corpus_texts(n=40, seed=0):
    rng = np.random.default_rng(seed)
    letters = np.array(list("abcdefghij"))
    return [" ".join("".join(rng.choice(letters, rng.integers(1, 5)))
                     for _ in range(rng.integers(1, 6)))
            for _ in range(n)]


@pytest.fixture(scope="module")
def sentences():
    tok = CharTokenizer(DECODER_PIECES)
    return [tok.encode_as_pieces(t) for t in corpus_texts()]


@pytest.fixture(scope="module")
def ngram_models(sentences):
    """(JAX BackoffNgramLM, port BackoffNgramLM), trained on the corpus."""
    return tuple(pkg.BackoffNgramLM(*pkg.train_backoff_ngram(
        sentences, order=ORDER)) for pkg in (jax_lm, port_lm))


def test_ngram_training_arpa_and_perplexity_match_jax(sentences):
    assert port_lm.count_ngrams(sentences, ORDER) \
        == jax_lm.count_ngrams(sentences, ORDER)
    want = jax_lm.train_backoff_ngram(sentences, order=ORDER)
    got = port_lm.train_backoff_ngram(sentences, order=ORDER)
    assert got == want
    texts = []
    for pkg, model in ((jax_lm, want), (port_lm, got)):
        f = io.StringIO()
        pkg.write_arpa(f, *model)
        texts.append(f.getvalue())
    assert texts[0] == texts[1] and texts[0].startswith("\\data\\")
    read = [pkg.read_arpa(io.StringIO(texts[0])) for pkg in (jax_lm,
                                                             port_lm)]
    assert read[0] == read[1]
    data = [list(port_lm.ngrams_for_evaluation(port_lm.pad_ends(s), ORDER))
            for s in sentences]
    assert data == [list(jax_lm.ngrams_for_evaluation(jax_lm.pad_ends(s),
                                                      ORDER))
                    for s in sentences]
    ppl = [pkg.ngram_perplexity(pkg.ngram_evaluation_details(
        data, pkg.BackoffNgramLM(*read[0][1:]))) for pkg in (jax_lm,
                                                              port_lm)]
    assert ppl[0] == ppl[1] and 1.0 < ppl[0] < len(DECODER_PIECES)


@pytest.mark.parametrize("bos_id", [None, 0])
def test_dense_table_and_fused_step_match_jax(ngram_models, bos_id):
    jax_model, model = ngram_models
    want = jax_lm.dense_ngram_table(jax_model, DECODER_PIECES, bos_id=bos_id)
    got = port_lm.dense_ngram_table(model, DECODER_PIECES, bos_id=bos_id)
    assert got.dtype == want.dtype and np.array_equal(got, want)
    assert got.shape == ((len(DECODER_PIECES) + 1) ** (ORDER - 1),
                         len(DECODER_PIECES))

    j_step, j_init = jax_lm.make_ngram_lm_step_fn(
        jax_model, DECODER_PIECES, bos_id=bos_id)
    step, init = port_lm.make_ngram_lm_step_fn(
        model, DECODER_PIECES, bos_id=bos_id, device="cpu")
    j_state, state = j_init(3), init(3)
    for tokens in ([0, 2, 5], [3, 3, 1], [11, 0, 4], [2, 6, 7]):
        j_lp, j_state = j_step(jnp.asarray(tokens), j_state)
        lp, state = step(torch.tensor(tokens), state)
        assert np.array_equal(lp.numpy(), np.asarray(j_lp))
        assert np.array_equal(state.numpy(), np.asarray(j_state))
    j_lp, _ = j_step(4, None)
    lp, _ = step(4, None)
    assert lp.shape == (len(DECODER_PIECES),)
    assert np.array_equal(lp.numpy(), np.asarray(j_lp))


def test_train_ngram_lm_tool_writes_the_jax_tools_arpa(tmp_path, capsys):
    import subprocess
    import sys
    from torch_port_helpers import REPO
    from tsasr_torch.tools import train_ngram_lm

    data = tmp_path / "data"
    data.mkdir()
    with open(data / "train-2mix.jsonl", "w") as f:
        for i, text in enumerate(corpus_texts()):
            f.write(json.dumps({"id": f"m{i}", "texts": [text]}) + "\n")
    CharTokenizer(DECODER_PIECES).save(str(tmp_path / "char_12.json"))
    args = ["--data_folder", str(data), "--tokenizer",
            str(tmp_path / "char_12.json"), "--order", str(ORDER)]
    res = subprocess.run(
        [sys.executable, "tools/train_ngram_lm.py", *args, "--out",
         str(tmp_path / "jax.arpa")], cwd=REPO, capture_output=True,
        text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-2000:]
    train_ngram_lm.main([*args, "--out", str(tmp_path / "port.arpa")])
    summary = json.loads(capsys.readouterr().out)
    want = json.loads(res.stdout.strip().splitlines()[-1])
    assert summary["train_perplexity"] == want["train_perplexity"]
    assert (tmp_path / "port.arpa").read_text() \
        == (tmp_path / "jax.arpa").read_text()


# --- the RNN-LM --------------------------------------------------------
def rnnlm_pair(vocab=len(DECODER_PIECES), seed=0):
    """(JAX RNNLM, its variables, the port's RNNLM with those weights)."""
    from tsasr_torch.convert import lm_params_from_flax
    from tsasr_tpu.models.lm import RNNLM as JaxLM
    from tsasr_tpu.models.lm import RNNLMConfig as JaxConfig
    config = dict(vocab_size=vocab, embedding_dim=8, hidden_size=12,
                  num_layers=2, dnn_neurons=8, dropout=0.0)
    jax_model = JaxLM(JaxConfig(**config))
    variables = jax_model.init(jax.random.PRNGKey(seed),
                               jnp.zeros((2, 3), jnp.int32))
    model = RNNLM(RNNLMConfig(**config))
    model.load_state_dict(lm_params_from_flax(
        jax.tree.map(np.asarray, variables)))
    return jax_model, variables, model.eval()


@pytest.fixture(scope="module")
def rnnlms():
    return rnnlm_pair()


def test_rnnlm_matches_jax(rnnlms, tmp_path):
    from tsasr_tpu.models.lm import lm_initial_state
    from tsasr_tpu.models.lm import make_lm_step_fn as jax_step_fn
    jax_model, variables, model = rnnlms
    tokens = np.array([[0, 2, 1, 3, 11], [4, 1, 0, 2, 7]], np.int32)
    want = jax_model.apply(variables, jnp.asarray(tokens))
    with torch.no_grad():
        got = model(torch.from_numpy(tokens).long())
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-5)

    j_step, step = jax_step_fn(jax_model, variables), make_lm_step_fn(model)
    j_state = lm_initial_state(jax_model, variables, 2)
    state = model.initial_state(2)
    for u in range(tokens.shape[1]):
        j_lp, j_state = j_step(jnp.asarray(tokens[:, u]), j_state)
        lp, state = step(torch.from_numpy(tokens[:, u]), state)
        np.testing.assert_allclose(lp.numpy(), np.asarray(j_lp), rtol=0,
                                   atol=1e-5)
    lp, state = step(2, None)                   # the exact beam's contract
    np.testing.assert_allclose(lp.numpy(), np.asarray(j_step(2, None)[0]),
                               rtol=0, atol=1e-5)
    assert lp.shape == (len(DECODER_PIECES),) and state[0].shape[1] == 1

    save_lm_checkpoint(model, tmp_path / "lm.ckpt")
    loaded = load_lm_checkpoint(tmp_path / "lm.ckpt", device="cpu")
    assert loaded.config == model.config and not loaded.training
    with torch.no_grad():
        assert torch.equal(loaded(torch.from_numpy(tokens).long()), got)


# --- fusion on synthetic models (tests/test_lm_fusion.py) ----------------
ACOUSTIC_2FRAME = np.log(np.array([
    # frame 0: token 1 edges out token 2; frame 1: blank dominates
    [0.10, 0.46, 0.44],
    [0.98, 0.011, 0.009]], np.float32))


def bounded_model(V, max_emits=1, penalty=-50.0):
    """The prediction state counts emissions: after ``max_emits`` every
    non-blank output is penalized into oblivion. State leaves are (N, 1)
    floats (the stream axis at -2, like the LSTM's)."""

    def predict_step(tokens, state):
        if state is None:
            state = torch.zeros(tokens.shape[0], 1)
        pen = torch.where(state >= max_emits, penalty, 0.0)
        dec = torch.cat([torch.zeros_like(pen),
                         pen.expand(pen.shape[0], V - 1)], dim=-1)
        return dec, state + 1.0

    def joint_step(enc_t, dec):
        return enc_t + dec

    return predict_step, joint_step


def constant_lm(probs):
    """An LM ignoring history: always the given row; a dummy (N, 1)
    state rides the beam's gathers."""
    row = torch.log(torch.tensor(probs, dtype=torch.float32))

    def step(tokens, state):
        tokens = torch.as_tensor(tokens)
        n = 1 if tokens.ndim == 0 else tokens.shape[0]
        if state is None:
            state = torch.zeros(n, 1)
        out = row if tokens.ndim == 0 else row.expand(n, row.shape[0])
        return out, state

    return step


def counting_lm(tokens, state):
    """Prefers token 1 first, then token 2 (state = emission count)."""
    if state is None:
        state = torch.zeros(tokens.shape[0], 1)
    first = torch.log(torch.tensor([0.1, 0.8, 0.1]))
    later = torch.log(torch.tensor([0.1, 0.1, 0.8]))
    return torch.where(state > 0, later, first), state + 1.0


def batched_fusion(lm_step=None, lm_weight=0.0, max_emits=1, table=None):
    table = ACOUSTIC_2FRAME if table is None else table
    predict, joint = bounded_model(3, max_emits=max_emits)
    tokens, lengths, _ = beam_search_batched(
        predict, joint, torch.zeros(2, 1), torch.from_numpy(table)[None],
        blank=0, beam_size=2, max_symbols=8, max_expansions=2,
        expand_beam=10.0, lm_step_fn=lm_step, lm_weight=lm_weight,
        lm_initial_state=None if lm_step is None else torch.zeros(2, 1))
    return tokens[0, 0, :lengths[0, 0]].tolist()


@pytest.mark.parametrize("case,best", [
    ("no_lm", [1]), ("neutral_lm", [1]), ("biased_lm", [2]),
    ("lm_state_advances", [1, 2])])
def test_batched_beam_fusion_cases(case, best):
    """The tokens ``tests/test_lm_fusion.py::TestBatchedBeamFusion``
    pins for the JAX beam."""
    if case == "no_lm":
        got = batched_fusion()
    elif case == "neutral_lm":
        got = batched_fusion(constant_lm([1 / 3] * 3), 0.5)
    elif case == "biased_lm":
        got = batched_fusion(constant_lm([0.05, 0.05, 0.9]), 2.0)
    else:
        table = np.repeat(ACOUSTIC_2FRAME[:1], 2, axis=0)
        got = batched_fusion(counting_lm, 3.0, max_emits=2, table=table)
    assert got == best


@pytest.mark.parametrize("lm_weight,best", [(0.0, [1]), (2.0, [2])])
def test_exact_beam_fusion_cases(lm_weight, best):
    """``TestHostBeamFusion``: no LM, the acoustic winner; a biased LM
    flips the host beam."""
    predict, joint = bounded_model(3)
    lm_step = constant_lm([0.05, 0.05, 0.9]) if lm_weight else None
    searcher = TransducerBeamSearcher(None, 0, beam_size=2, nbest=1,
                                      lm_step_fn=lm_step,
                                      lm_weight=lm_weight, expand_beam=10.0)
    searcher._predict_step = \
        lambda token, state, device: predict(torch.tensor([token]), state)
    searcher._joint_log_probs = \
        lambda enc_t, dec: joint(enc_t[None], dec)[0].numpy()
    searcher._initial_state = lambda device: torch.zeros(1, 1)
    hyps, _, _, _ = searcher(torch.from_numpy(ACOUSTIC_2FRAME)[None])
    assert hyps == [best]


def test_rnnlm_states_ride_the_batched_beam():
    """The RNN-LM's (L, N, H) states through the batched beam's gathers
    and emission-masked advances, in both packages: the same tokens."""
    from tsasr_tpu.decoding.beam_batched import beam_search_batched as jbs
    from tsasr_tpu.models.lm import lm_initial_state
    from tsasr_tpu.models.lm import make_lm_step_fn as jax_step_fn
    j_lm, j_variables, model = rnnlm_pair(vocab=3)
    table = np.repeat(ACOUSTIC_2FRAME[:1], 3, axis=0)

    def j_predict(tokens, state):
        pen = jnp.where(state >= 2, -50.0, 0.0)
        return (jnp.concatenate([jnp.zeros_like(pen),
                                 jnp.broadcast_to(pen, (pen.shape[0], 2))],
                                axis=-1), state + 1.0)

    want = jbs(j_predict, lambda e, d: e + d, jnp.zeros((2, 1)),
               jnp.asarray(table)[None], blank=0, beam_size=2,
               max_symbols=6, max_expansions=2, expand_beam=10.0,
               lm_step_fn=jax_step_fn(j_lm, j_variables), lm_weight=0.7,
               lm_initial_state=lm_initial_state(j_lm, j_variables, 2))
    predict, joint = bounded_model(3, max_emits=2)
    got = beam_search_batched(
        predict, joint, torch.zeros(2, 1), torch.from_numpy(table)[None],
        blank=0, beam_size=2, max_symbols=6, max_expansions=2,
        expand_beam=10.0, lm_step_fn=make_lm_step_fn(model), lm_weight=0.7,
        lm_initial_state=model.initial_state(2))
    assert_same_beams(got, want)
    assert all(t in (1, 2) for t in got[0][0, 0, :got[1][0, 0]].tolist())


# --- both beams with each LM on a real predictor and joint ---------------
def fusion_pair(kind, ngram_models, rnnlms):
    """((JAX step, JAX initial state fn), (port step, port initial state
    fn)) of one LM."""
    if kind == "ngram":
        jax_model, model = ngram_models
        return (jax_lm.make_ngram_lm_step_fn(jax_model, DECODER_PIECES,
                                             bos_id=0),
                port_lm.make_ngram_lm_step_fn(model, DECODER_PIECES,
                                              bos_id=0, device="cpu"))
    from tsasr_tpu.models.lm import lm_initial_state
    from tsasr_tpu.models.lm import make_lm_step_fn as jax_step_fn
    jax_model, variables, model = rnnlms
    return ((jax_step_fn(jax_model, variables),
             lambda n: lm_initial_state(jax_model, variables, n)),
            (make_lm_step_fn(model), model.initial_state))


@pytest.mark.parametrize("kind", ["ngram", "rnnlm"])
def test_batched_beam_with_lm_matches_jax(kind, ngram_models, rnnlms):
    from tsasr_tpu.decoding import BatchedBeamSearcher as JaxBatched
    (j_step, j_init), (step, init) = fusion_pair(kind, ngram_models, rnnlms)
    jax_model, params, model = decoder_models()
    enc, rel = encoder_output()
    want = JaxBatched(jax_model, params, beam_size=4, nbest=4,
                      lm_step_fn=j_step, lm_weight=LM_WEIGHT,
                      lm_initial_state_fn=j_init)
    got = BatchedBeamSearcher(model, beam_size=4, nbest=4, lm_step_fn=step,
                              lm_weight=LM_WEIGHT, lm_initial_state_fn=init)
    w = want._jitted(params, jnp.asarray(enc), jnp.asarray(rel))
    g = got.decode(torch.from_numpy(enc), torch.from_numpy(rel))
    assert_same_beams(g, w)
    no_lm = BatchedBeamSearcher(model, beam_size=4, nbest=4).decode(
        torch.from_numpy(enc), torch.from_numpy(rel))
    assert not torch.equal(no_lm[2], g[2])      # the LM took part


@pytest.mark.parametrize("kind", ["ngram", "rnnlm"])
def test_exact_beam_with_lm_matches_jax(kind, ngram_models, rnnlms):
    from tsasr_tpu.decoding import TransducerBeamSearcher as JaxExact
    (j_step, _), (step, _) = fusion_pair(kind, ngram_models, rnnlms)
    jax_model, params, model = decoder_models()
    enc, rel = encoder_output(batch=2, frames=3)
    want = JaxExact(jax_model, params, 0, beam_size=3, nbest=3,
                    lm_step_fn=j_step, lm_weight=LM_WEIGHT)
    got = TransducerBeamSearcher(model, 0, beam_size=3, nbest=3,
                                 lm_step_fn=step, lm_weight=LM_WEIGHT)
    hyps, _, nbest, scores = got(torch.from_numpy(enc),
                                 torch.from_numpy(rel))
    w_hyps, _, w_nbest, w_scores = want(jnp.asarray(enc), jnp.asarray(rel))
    assert hyps == w_hyps and nbest == w_nbest
    for a, b in zip(scores, w_scores):
        np.testing.assert_allclose(a, b, rtol=0, atol=SCORE_ATOL)
