"""Chunked streaming transcription for causal models.

Counterpart of the JAX package's ``inference/streaming.py``
(``StreamingTranscriber``). Audio arrives in chunks; the emitted tokens
and the prediction network's state carry across chunks, so a partial
transcript is ready at every chunk. Two modes:

- ``reencode`` (the default): re-encode the audio history each chunk
  (Fbank, sentence normalization over the history, the offline encode,
  so the fused attention kernel on the card) and greedy-decode only the
  new encoder frames, holding back the last ``holdback`` frames, whose
  features still see the STFT's zero padding where future audio
  belongs, until the next chunk or ``finalize``. ``max_history_seconds``
  bounds the history, trimmed in whole encoder frames;
- ``kv_cache``: compute only the new complete feature frames, in
  multiples of 4 (the frontend's subsampling), from a ring of raw audio
  with the STFT's left context, and stream them through
  ``TSTransducer.encode_stream`` (frontend rows, per-layer KV and conv
  caches); ``finalize`` pads the half window of zeros the offline
  centred STFT pads and drops the tail under 4 frames. As in JAX, these
  features are not normalized (sentence statistics need the whole
  utterance) and their ``top_db`` clamp is the chunk's.

Greedy search emits at most one token a frame, as the JAX streamer does
(the offline greedy search also emits at most one), and reads each
frame's token back to the host.

Differences from the JAX streamer:

- a model with a speaker input (``injection_mode`` set: a ``scratch``
  or a ``pretrained`` model) needs ``speaker_embs`` and raises without
  them, where the JAX streamer runs without conditioning
  (``TSASRTranscriber.speaker_embedding`` gives them from an
  enrollment);
- ``kv_cache`` needs a causal model (``causal_encoder`` and
  ``frontend_causal``) and raises otherwise, and a stream longer than
  ``kv_capacity_seconds`` raises (``models.attention``) where JAX
  overwrites the buffer's last slots;
- ``reencode`` with ``max_history_seconds`` maps the trimmed samples to
  the encoder frames they held (one per 4 hops). The JAX streamer counts
  the frames a signal of that many samples would give, one more, and
  decodes the last decoded frame a second time after every trim.
"""

import numpy as np
import torch

from tsasr_torch.device import resolve_device
from tsasr_torch.ops.features import (Fbank, amplitude_to_db,
                                      input_normalization,
                                      spectral_magnitude, stft)

SUBSAMPLING = 4
MODES = ("reencode", "kv_cache")


class StreamingTranscriber:
    """Stateful chunk-by-chunk transcription of one stream.

    ``model`` is a ``TSTransducer``; ``params`` a ``state_dict`` to load
    into it, or None. The model moves to ``device`` (default CUDA, which
    raises when absent). ``speaker_embs`` (1, 1, d_model), or the
    speaker frames (1, S, d_model) of a ``cross_attention`` model,
    condition a model with a speaker input; no lengths go with them, as
    in JAX, so every frame given is attended.
    ``TSASRTranscriber.speaker_embedding`` gives them for a ``scratch`` or
    a ``pretrained`` model (the frozen WavLM's d-vector or frames,
    projected), the frames cut to those the offline encode leaves
    unmasked.
    """

    def __init__(self, model, params, tokenizer, sample_rate=16000,
                 n_fft=512, n_mels=80, win_length=32.0, hop_ms=10.0,
                 blank_index=0, speaker_embs=None,
                 max_history_seconds=None, mode="reencode",
                 kv_capacity_seconds=60.0, device="cuda"):
        if mode not in MODES:
            raise ValueError(f"mode {mode!r} is not one of {MODES}")
        c = model.config
        if c.injection_mode is not None and speaker_embs is None:
            raise ValueError(
                "this model has a speaker branch (injection_mode "
                f"{c.injection_mode!r}): pass speaker_embs, e.g. "
                "TSASRTranscriber.speaker_embedding(enrollment)")
        if mode == "kv_cache" and not (c.causal_encoder
                                       and c.frontend_causal):
            raise ValueError(
                "kv_cache streaming needs a causal model (causal_encoder "
                "and frontend_causal); use mode='reencode'")
        self.device = resolve_device(device)
        if params is not None:
            model.load_state_dict(params)
        self.model = model.to(self.device).eval()
        self.tokenizer = tokenizer
        self.sample_rate = sample_rate
        self.n_fft = n_fft
        self.hop = int(round(sample_rate / 1000.0 * hop_ms))
        self.blank = blank_index
        self.speaker_embs = None if speaker_embs is None \
            else speaker_embs.to(self.device)
        self.mode = mode
        self.max_history = (int(max_history_seconds * sample_rate)
                            if max_history_seconds else None)
        self.kv_capacity = int(kv_capacity_seconds * sample_rate
                               / self.hop / SUBSAMPLING) + 8
        self.fbank = Fbank(sample_rate=sample_rate, n_fft=n_fft,
                           n_mels=n_mels, win_length=win_length
                           ).to(self.device)
        # the STFT's centre padding reaches the last ceil((n_fft/2)/hop)
        # + 1 feature frames of a partial signal: hold back the encoder
        # frames that see them
        contaminated_feat = -(-(n_fft // 2) // self.hop) + 1
        self.holdback = -(-contaminated_feat // SUBSAMPLING)
        self.reset()

    def reset(self):
        self._audio = np.zeros(0, np.float32)
        self._decoded_frames = 0      # global encoder frames consumed
        self._dropped_samples = 0     # history trimmed off the window
        self._tokens = []
        self._pn_state = None
        self._dec_out = None
        self._enc_state = None        # kv_cache mode
        self._feat_frames_done = 0
        self._total_samples = 0

    # ----------------------------------------------------------- chunks
    @torch.inference_mode()
    def accept_chunk(self, chunk, final=False):
        """Feed new audio; returns the transcript so far."""
        if self.mode == "kv_cache":
            return self._accept_chunk_kv(chunk, final)
        chunk = np.asarray(chunk, np.float32)
        self._audio = np.concatenate([self._audio, chunk])
        frame_samples = SUBSAMPLING * self.hop
        if self.max_history and len(self._audio) > self.max_history:
            # trim whole encoder frames so frame indices stay aligned
            drop = len(self._audio) - self.max_history
            drop -= drop % frame_samples
            self._audio = self._audio[drop:]
            self._dropped_samples += drop

        window_start = self._dropped_samples // frame_samples
        enc = self._encode(torch.from_numpy(self._audio)[None]
                           .to(self.device))
        new_lo = self._decoded_frames - window_start
        hi = enc.shape[1] if final else \
            max(enc.shape[1] - self.holdback, 0)
        if new_lo < hi:
            self._greedy_frames(enc[:, max(new_lo, 0): hi])
            self._decoded_frames = window_start + hi
        return self.partial_transcript()

    def finalize(self):
        """End of stream: decode the held-back tail, return the final
        transcript."""
        if self.mode == "kv_cache" or len(self._audio):
            self.accept_chunk(np.zeros(0, np.float32), final=True)
        return self.partial_transcript()

    # ----------------------------------------------------- kv_cache mode
    def _accept_chunk_kv(self, chunk, final=False):
        """Compute only the new complete feature frames, stream them
        through the cached encoder, greedy-decode the new frames."""
        chunk = np.asarray(chunk, np.float32)
        self._audio = np.concatenate([self._audio, chunk])
        self._total_samples += len(chunk)
        half = self.n_fft // 2

        # feature frame f covers samples [f*hop - half, f*hop + half)
        if final:
            # the offline centre padding: half a window of zeros on the
            # right
            self._audio = np.concatenate(
                [self._audio, np.zeros(half, np.float32)])
            self._total_samples += half
            f_avail = 1 + (self._total_samples - self.n_fft
                           + half) // self.hop
        else:
            f_avail = (self._total_samples - half) // self.hop + 1
        n_new = f_avail - self._feat_frames_done
        n_new -= n_new % SUBSAMPLING     # the frontend takes multiples of 4
        if n_new <= 0:
            return self.partial_transcript()

        # the audio under the new frames, left context included
        f_lo = self._feat_frames_done
        samp_lo = f_lo * self.hop - half
        samp_hi = (f_lo + n_new - 1) * self.hop + half
        buf_offset = self._total_samples - len(self._audio)
        lo = samp_lo - buf_offset
        window = self._audio[max(lo, 0): samp_hi - buf_offset]
        if lo < 0:                    # stream start: the offline left pad
            window = np.concatenate([np.zeros(-lo, np.float32), window])

        feats = self._frames_to_feats(window, n_new)
        if self._enc_state is None:
            self._enc_state = self.model.init_stream_state(
                1, self.kv_capacity, self.device)
        enc_new, self._enc_state = self.model.encode_stream(
            feats, self._enc_state, self.speaker_embs)
        self._greedy_frames(enc_new)
        self._feat_frames_done += n_new

        # drop consumed audio, keeping the next frame's left context
        keep_from = (self._feat_frames_done * self.hop - half) - buf_offset
        if keep_from > 0:
            self._audio = self._audio[keep_from:]
        return self.partial_transcript()

    def _frames_to_feats(self, window, n_frames):
        """Log-mel frames of a raw sample window with its context (no
        centre padding: the window carries it)."""
        wav = torch.from_numpy(window)[None].to(self.device)
        re, im = stft(wav, sample_rate=self.sample_rate,
                      win_length=self.n_fft * 1000.0 / self.sample_rate,
                      hop_length=self.hop * 1000.0 / self.sample_rate,
                      n_fft=self.n_fft, center=False)
        fbanks = torch.matmul(spectral_magnitude(re, im), self.fbank.mel)
        return amplitude_to_db(fbanks)[:, :n_frames]

    def partial_transcript(self):
        return " ".join(self.tokenizer.decode_ids_to_words(self._tokens))

    # ------------------------------------------------------------ device
    def _encode(self, wav):
        rel = torch.ones(1, device=self.device)
        feats = input_normalization(self.fbank(wav), rel)
        return self.model.encode(feats, rel, self.speaker_embs)

    def _greedy_frames(self, enc_frames):
        """Greedy search over new encoder frames (1, n, J), carrying the
        prediction network's state; at most one token a frame."""
        model = self.model
        if self._pn_state is None:
            self._pn_state = model.predictor_initial_state(1, self.device)
            last = self._tokens[-1] if self._tokens else self.blank
            self._dec_out, self._pn_state = model.predict_step(
                torch.tensor([last], device=self.device), self._pn_state)
        for t in range(enc_frames.shape[1]):
            logits = model.joint_logits(enc_frames[:, t][:, None, :],
                                        self._dec_out[:, None, :])[0, 0]
            token = int(torch.argmax(logits))
            if token != self.blank:
                self._tokens.append(token)
                self._dec_out, self._pn_state = model.predict_step(
                    torch.tensor([token], device=self.device),
                    self._pn_state)
