"""Visualization helpers: waveform / fbank / attention / embedding /
grad-norm plots and waveform export.

Counterpart of the JAX package's ``utils/visualization.py``, the plots
behind the recipe's ``plot_data`` / ``plot_attentions`` /
``plot_embeddings`` / ``plot_grad_norm`` switches. matplotlib (with the
Agg backend) and, for ``plot_embeddings``, scikit-learn's TSNE are
imported when a plot is made; where either is missing, the plot raises
an ``ImportError`` that names the package, so a switch that is set never
goes unplotted. The fbank image uses the port's own ``Fbank`` on the
CPU.
"""

import os

import numpy as np


def _require(module, package):
    import importlib
    try:
        return importlib.import_module(module)
    except ImportError as e:
        raise ImportError(
            f"the plot_* switches need {package} ({module} did not "
            f"import: {e}); install it or turn the switch off") from e


def require_plot_packages(embeddings=False):
    """Import what the plots need (matplotlib; scikit-learn too for
    ``embeddings``), raising the ``ImportError`` of a missing one: the
    recipe calls it before anything runs."""
    _plt()
    if embeddings:
        _require("sklearn.manifold", "scikit-learn")


def _plt():
    matplotlib = _require("matplotlib", "matplotlib")
    matplotlib.use("Agg")
    return _require("matplotlib.pyplot", "matplotlib")


def _save(plt, fig, output_image):
    fig.tight_layout()
    os.makedirs(os.path.dirname(output_image) or ".", exist_ok=True)
    fig.savefig(output_image, dpi=150)
    plt.close(fig)


def plot_waveform(waveforms, sample_rate, output_image, labels=None,
                  opacity=1.0, legend=False):
    """One or several waveforms overlaid on a shared time axis."""
    plt = _plt()
    if isinstance(waveforms, np.ndarray) and waveforms.ndim == 1:
        waveforms = [waveforms]
    elif not isinstance(waveforms, (list, tuple)):
        waveforms = [np.asarray(waveforms)]
    fig, ax = plt.subplots(figsize=(10, 3))
    for i, wav in enumerate(waveforms):
        wav = np.asarray(wav)
        t = np.arange(len(wav)) / sample_rate
        label = labels[i] if labels and i < len(labels) else None
        ax.plot(t, wav, alpha=opacity, linewidth=0.5, label=label)
    ax.set_xlabel("time (s)")
    ax.set_ylabel("amplitude")
    if legend and labels:
        ax.legend(fontsize=8)
    _save(plt, fig, output_image)


def plot_fbanks(waveform, sample_rate, output_image, n_mels=80,
                n_fft=512, win_length=32.0):
    """Log-mel spectrogram image of one waveform."""
    import torch
    from tsasr_torch.ops.features import Fbank
    plt = _plt()
    fbank = Fbank(sample_rate=sample_rate, n_fft=n_fft, n_mels=n_mels,
                  win_length=win_length)
    with torch.no_grad():
        feats = fbank(torch.from_numpy(np.asarray(waveform, np.float32))
                      [None])[0]
    fig, ax = plt.subplots(figsize=(10, 3))
    im = ax.imshow(feats.numpy().T, aspect="auto", origin="lower",
                   interpolation="nearest")
    ax.set_xlabel("frame")
    ax.set_ylabel("mel bin")
    fig.colorbar(im, ax=ax)
    _save(plt, fig, output_image)


def plot_attention(attention, output_image):
    """Attention heads (H, T, S) as a grid of heatmaps."""
    plt = _plt()
    attention = np.asarray(attention, np.float32)
    if attention.ndim == 2:
        attention = attention[None]
    n_heads = attention.shape[0]
    cols = min(n_heads, 4)
    rows = -(-n_heads // cols)
    fig, axes = plt.subplots(rows, cols,
                             figsize=(3.2 * cols, 2.8 * rows),
                             squeeze=False)
    for h in range(n_heads):
        ax = axes[h // cols][h % cols]
        ax.imshow(attention[h], aspect="auto", origin="lower")
        ax.set_title(f"head {h}", fontsize=8)
    _save(plt, fig, output_image)


def plot_embeddings(embeddings, speaker_labels, output_image, title=None,
                    perplexity=30):
    """t-SNE projection of speaker embeddings colored by speaker."""
    plt = _plt()
    manifold = _require("sklearn.manifold", "scikit-learn")
    embeddings = np.asarray(embeddings, np.float32)
    perplexity = max(1, min(perplexity, len(embeddings) - 1))
    proj = manifold.TSNE(n_components=2, perplexity=perplexity,
                         init="pca", random_state=0).fit_transform(
        embeddings)
    speakers = sorted(set(speaker_labels))
    fig, ax = plt.subplots(figsize=(6, 5))
    for spk in speakers:
        idx = [i for i, s in enumerate(speaker_labels) if s == spk]
        ax.scatter(proj[idx, 0], proj[idx, 1], s=12, label=str(spk))
    if len(speakers) <= 20:
        ax.legend(fontsize=7)
    if title:
        ax.set_title(title)
    _save(plt, fig, output_image)


def plot_grad_norm(grad_norms, output_image="grad_norm.jpg"):
    """Per-step gradient-norm curve."""
    plt = _plt()
    fig, ax = plt.subplots(figsize=(8, 3))
    ax.plot(np.asarray(grad_norms), linewidth=0.7)
    ax.set_xlabel("step")
    ax.set_ylabel("grad norm")
    ax.set_yscale("log")
    ax.grid(alpha=0.3)
    _save(plt, fig, output_image)


def play_waveform(waveform, sample_rate, output_wav):
    """Export a waveform as a playable WAV (16-bit PCM)."""
    from tsasr_torch.data.audio import write_wav
    os.makedirs(os.path.dirname(output_wav) or ".", exist_ok=True)
    write_wav(output_wav, np.asarray(waveform), sample_rate)
