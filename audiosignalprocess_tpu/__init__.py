"""audiosignalprocess_tpu — an audio signal-processing framework in JAX.

A from-scratch JAX/XLA re-design of the capability surface of
templeblock/audioSignalProcess (reference unavailable at survey time; the
binding capability spec is BASELINE.json — see SURVEY.md §0):

- FFT/IFFT through XLA (cuFFT on the GPU), plus radix-2 / split-radix and
  a "four-step" matmul FFT
- windowed-sinc FIR design, direct FIR, overlap-save fast block convolution
- polyphase rational resampling (e.g. 44.1 kHz -> 48 kHz = 160/147)
- STFT analysis / ISTFT synthesis (WOLA)
- envelope follower / AM demod, spectral noise gate, phase-vocoder
  pitch/time processing
- channel + time-block sharding over a jax.sharding.Mesh with halo
  exchange (ppermute) and frame-boundary collectives
- a streaming block pipeline with exact carry state (block-streamed
  output == whole-file output)

Numerical conventions are pinned by ``audiosignalprocess_tpu.cpu_ref``
(float64 numpy oracle + optional C oracle in ``native/``); every JAX
path is tested against the oracle for >= 60 dB SNR and exact structural
parity (lengths, framing, layout).
"""

__version__ = "0.1.0"

from audiosignalprocess_tpu.ops import windows, fft, stft, fir, overlap_save, resample  # noqa: F401
from audiosignalprocess_tpu import effects, parallel, io  # noqa: F401
from audiosignalprocess_tpu.pipeline import Chain  # noqa: F401
from audiosignalprocess_tpu import api  # noqa: F401
