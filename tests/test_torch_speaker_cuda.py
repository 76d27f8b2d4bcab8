"""The speaker side's serving paths on the card against the same code on
the CPU: the ``pretrained`` transcriber (pooled and ``cross_attention``)
and ``SpeakerRecognition`` (``from_tsasr``, ``from_wavlm``). Marked
``cuda``: they skip on hosts without a GPU and run on one with ``python
-m pytest tests/test_torch_speaker_cuda.py --noconftest -m cuda`` (this
module imports no JAX). f32 on both sides, the card's attention through
the CUDA kernel: encoder outputs within 1e-4, one kernel launch per
Conformer layer."""

import numpy as np
import pytest
import torch

from tsasr_torch.data.tokenizer import CharTokenizer
from tsasr_torch.inference import SpeakerRecognition, TSASRTranscriber
from tsasr_torch.kernels import relpos_attention
from tsasr_torch.models import wavlm
from tsasr_torch.models.transducer import TSTransducer, TSTransducerConfig
from tsasr_torch.ops.features import Fbank
from tsasr_torch.recipes.speaker_embeddings import FrozenSpeakerEncoder

pytestmark = pytest.mark.cuda

ATOL = 1e-4
PIECES = ["<unk>", "▁"] + list("abcdefghijklmnopqrstuvwxyz'")
SMALL = dict(d_model=64, nhead=4, encoder_num_layers=2, d_ffn=128,
             kernel_size=7, speaker_encoder_layers=2, decoder_neurons=64,
             joint_dim=64, frontend_channels=(16, 16), dropout=0.0,
             fused_attention=True)
WAVLM_SMALL = dict(hidden_size=64, num_hidden_layers=2,
                   num_attention_heads=4, intermediate_size=96,
                   conv_dim=[16] * 7, num_conv_pos_embeddings=16,
                   num_conv_pos_embedding_groups=4, num_buckets=20,
                   max_bucket_distance=40, tdnn_dim=[32, 32, 48],
                   tdnn_kernel=[3, 3, 1], tdnn_dilation=[1, 2, 1],
                   xvector_output_dim=24)
FBANK = dict(sample_rate=16000, n_fft=512, n_mels=80, win_length=32.0)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (and nvcc to build the kernels)")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def wavlm_dir(tmp_path_factory):
    path = tmp_path_factory.mktemp("wavlm_small")
    model = wavlm.WavLMForXVector(wavlm.WavLMConfig.from_hf_dict(
        WAVLM_SMALL))
    wavlm.save_pretrained_xvector(model.init_weights(seed=3), str(path))
    return str(path)


def audio(seed=0):
    rng = np.random.default_rng(seed)
    return ([(rng.normal(size=n) * 0.1).astype(np.float32)
             for n in (32000, 21000)],
            [(rng.normal(size=n) * 0.1).astype(np.float32)
             for n in (27000, 40000)])


@pytest.mark.parametrize("mode,dim", [("cat", 24), ("cross_attention", 48)])
def test_pretrained_transcriber_on_the_card_matches_the_cpu(cuda, wavlm_dir,
                                                           mode, dim):
    config = dict(SMALL, use_speaker_encoder=False,
                  speaker_embedding_dim=dim, injection_mode=mode)
    state = TSTransducer(TSTransducerConfig(**config)).init_weights(
        seed=1).state_dict()
    wavs, enrolls = audio()
    outs = {}
    for device in ("cpu", "cuda"):
        model = TSTransducer(TSTransducerConfig(**config))
        encoder = FrozenSpeakerEncoder(
            wavlm_dir, frame_level=mode == "cross_attention",
            embedding_dim=dim, device=device)
        tr = TSASRTranscriber(model, state, CharTokenizer(PIECES),
                              variant="pretrained", speaker_encoder=encoder,
                              pad_to_multiple={"enroll_sig": 16000},
                              device=device)
        before = relpos_attention.launches
        enc, _ = tr.encode_batch(wavs, enrolls)
        torch.cuda.synchronize()
        outs[device] = (enc.cpu(), relpos_attention.launches - before,
                        tr.speaker_embedding(enrolls[0]).cpu())
    assert outs["cuda"][1] == SMALL["encoder_num_layers"]
    assert outs["cpu"][1] == 0
    np.testing.assert_allclose(outs["cuda"][0].numpy(),
                               outs["cpu"][0].numpy(), rtol=0, atol=ATOL)
    np.testing.assert_allclose(outs["cuda"][2].numpy(),
                               outs["cpu"][2].numpy(), rtol=0, atol=ATOL)


def test_from_tsasr_launches_once_a_speaker_layer(cuda):
    config = dict(SMALL, injection_mode="cat")
    state = TSTransducer(TSTransducerConfig(**config)).init_weights(
        seed=2).state_dict()
    _, enrolls = audio(1)
    embs = {}
    for device in ("cpu", "cuda"):
        model = TSTransducer(TSTransducerConfig(**config))
        model.load_state_dict(state)
        sr = SpeakerRecognition.from_tsasr(model.to(device),
                                           Fbank(**FBANK).to(device),
                                           device=device)
        rel = [len(e) / 40000 for e in enrolls]
        batch = np.zeros((2, 40000), np.float32)
        for i, e in enumerate(enrolls):
            batch[i, :len(e)] = e
        before = relpos_attention.launches
        embs[device] = sr.encode_batch(batch, rel).cpu()
        torch.cuda.synchronize()
        launched = relpos_attention.launches - before
        assert launched == (SMALL["speaker_encoder_layers"]
                            if device == "cuda" else 0)
    np.testing.assert_allclose(embs["cuda"].numpy(), embs["cpu"].numpy(),
                               rtol=0, atol=ATOL)


def test_from_wavlm_on_the_card_matches_the_cpu(cuda, wavlm_dir):
    wavs, _ = audio(2)
    batch = np.zeros((2, 32000), np.float32)
    for i, w in enumerate(wavs):
        batch[i, :len(w)] = w
    rel = [1.0, 21000 / 32000]
    got = SpeakerRecognition.from_wavlm(wavlm_dir, device="cuda")
    want = SpeakerRecognition.from_wavlm(wavlm_dir, device="cpu")
    e_card, e_cpu = got.encode_batch(batch, rel).cpu(), \
        want.encode_batch(batch, rel)
    np.testing.assert_allclose(e_card.numpy(), e_cpu.numpy(), rtol=0,
                               atol=ATOL * e_cpu.abs().max().item())
    s_card, _ = got.verify_batch(batch, batch[::-1].copy(), rel, rel[::-1])
    s_cpu, _ = want.verify_batch(batch, batch[::-1].copy(), rel, rel[::-1])
    np.testing.assert_allclose(s_card, s_cpu, rtol=0, atol=ATOL)
