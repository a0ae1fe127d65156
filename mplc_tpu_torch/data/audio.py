"""Audio features: librosa-compatible MFCCs in NumPy (port of
`mplc_tpu/data/audio.py`, the same arithmetic).

ESC-50 clips become MFCC images as the reference computes them with
`librosa.feature.mfcc(y, sr, n_mfcc=40)`: STFT power (periodic Hann window,
centered with reflect padding), a Slaney-style mel filterbank, `power_to_db`
with an 80 dB range, an orthonormal DCT-II. Defaults are librosa's:
n_fft=2048, hop_length=512, n_mels=128, fmin=0, fmax=sr/2. A 5 s, 44.1 kHz
clip gives [40, 431], the ESC50 CNN's input (40, 431, 1).
`load_wav` reads a WAV file through `scipy.io.wavfile`; it scales a stereo
integer clip before averaging its channels, where the JAX package does not.
"""

from __future__ import annotations

import numpy as np


def hann_window(n: int) -> np.ndarray:
    # periodic hann, like scipy.signal.get_window("hann", n, fftbins=True)
    return 0.5 * (1.0 - np.cos(2.0 * np.pi * np.arange(n) / n))


def stft_power(y: np.ndarray, n_fft: int = 2048, hop_length: int = 512) -> np.ndarray:
    """Power spectrogram |STFT|^2, centered with reflect padding.
    [n_samples] -> [1 + n_fft//2, 1 + n_samples//hop_length]."""
    y = np.asarray(y, np.float64)
    pad = n_fft // 2
    y = np.pad(y, pad, mode="reflect")
    n_frames = 1 + (len(y) - n_fft) // hop_length
    idx = (np.arange(n_fft)[None, :]
           + hop_length * np.arange(n_frames)[:, None])    # [T, n_fft]
    frames = y[idx] * hann_window(n_fft)[None, :]
    spec = np.fft.rfft(frames, n=n_fft, axis=1)            # [T, 1+n_fft/2]
    return (spec.real ** 2 + spec.imag ** 2).T             # [F, T]


def hz_to_mel(f):
    """Slaney mel scale (librosa default, htk=False): linear below 1 kHz,
    logarithmic above."""
    f = np.asarray(f, np.float64)
    f_sp = 200.0 / 3
    mel = f / f_sp
    min_log_hz = 1000.0
    logstep = np.log(6.4) / 27.0
    above = f >= min_log_hz
    mel = np.where(above,
                   min_log_hz / f_sp + np.log(np.maximum(f, 1e-10) / min_log_hz) / logstep,
                   mel)
    return mel


def mel_to_hz(m):
    m = np.asarray(m, np.float64)
    f_sp = 200.0 / 3
    freq = m * f_sp
    min_log_mel = 1000.0 / f_sp
    logstep = np.log(6.4) / 27.0
    above = m >= min_log_mel
    return np.where(above, 1000.0 * np.exp(logstep * (m - min_log_mel)), freq)


def mel_filterbank(sr: int, n_fft: int, n_mels: int = 128,
                   fmin: float = 0.0, fmax: float | None = None) -> np.ndarray:
    """Slaney-normalized triangular mel filterbank [n_mels, 1 + n_fft//2]."""
    if fmax is None:
        fmax = sr / 2.0
    fft_freqs = np.linspace(0, sr / 2.0, 1 + n_fft // 2)
    mel_pts = mel_to_hz(np.linspace(hz_to_mel(fmin), hz_to_mel(fmax), n_mels + 2))
    fb = np.zeros((n_mels, len(fft_freqs)))
    for i in range(n_mels):
        lower = (fft_freqs - mel_pts[i]) / (mel_pts[i + 1] - mel_pts[i])
        upper = (mel_pts[i + 2] - fft_freqs) / (mel_pts[i + 2] - mel_pts[i + 1])
        fb[i] = np.maximum(0.0, np.minimum(lower, upper))
        # Slaney area normalization
        fb[i] *= 2.0 / (mel_pts[i + 2] - mel_pts[i])
    return fb


def power_to_db(S: np.ndarray, top_db: float = 80.0) -> np.ndarray:
    ref = np.maximum(S.max(), 1e-10)
    log_spec = 10.0 * np.log10(np.maximum(S, 1e-10))
    log_spec -= 10.0 * np.log10(ref)
    return np.maximum(log_spec, -top_db)


def dct_ortho(x: np.ndarray, n_out: int) -> np.ndarray:
    """Orthonormal DCT-II over axis 0, truncated to n_out coefficients
    (scipy.fftpack.dct(x, type=2, norm='ortho') equivalent)."""
    n = x.shape[0]
    k = np.arange(n_out)[:, None]                     # [n_out, 1]
    i = np.arange(n)[None, :]                         # [1, n]
    basis = np.cos(np.pi * k * (2 * i + 1) / (2 * n))  # [n_out, n]
    scale = np.full((n_out, 1), np.sqrt(2.0 / n))
    scale[0, 0] = np.sqrt(1.0 / n)
    return (basis * scale) @ x


def mfcc(y: np.ndarray, sr: int, n_mfcc: int = 40, n_fft: int = 2048,
         hop_length: int = 512, n_mels: int = 128) -> np.ndarray:
    """MFCC matrix [n_mfcc, n_frames] with librosa-default semantics."""
    S = stft_power(y, n_fft=n_fft, hop_length=hop_length)
    mel = mel_filterbank(sr, n_fft, n_mels=n_mels) @ S
    return dct_ortho(power_to_db(mel), n_mfcc)


def load_wav(path) -> tuple[np.ndarray, int]:
    """(mono float64 samples in [-1, 1], sample_rate) via scipy. Integer
    samples are scaled to [-1, 1] before a multi-channel clip is averaged
    to mono. (The JAX package averages first, which turns the samples into
    floats, so a stereo integer clip keeps its raw integer range; mono
    clips, ESC-50's, are the same in both.)"""
    from scipy.io import wavfile
    sr, data = wavfile.read(path)
    data = np.asarray(data)
    if data.dtype.kind == "i":
        data = data / float(np.iinfo(data.dtype).max)
    elif data.dtype.kind == "u":
        data = (data.astype(np.float64) - 128.0) / 128.0
    if data.ndim == 2:                                # stereo -> mono
        data = data.mean(axis=1)
    return data.astype(np.float64), int(sr)
