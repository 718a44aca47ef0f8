"""ninwavelets_tpu — an accelerator-native analytic-wavelet transform engine.

A from-scratch JAX/XLA/Pallas rebuild of the capabilities of
``Hiroki-Maeda/ninwavelets``: Generalized Morse, Morlet/Gabor, Shannon,
MexicanHat and Haar filter banks synthesized on device in the frequency
domain, CWT computed as one batched FFT x bank x iFFT program, with power /
ITC / baseline correction fused, and multi-device scale-out via
``jax.sharding`` (epoch/channel/frequency sharding and halo-exchange chunked
convolution for long signals).

The top-level exports mirror the reference package surface
(``/root/reference/ninwavelets/__init__.py:1-3``) plus the functional core
under ``ninwavelets_tpu.ops`` and the sharded engine under
``ninwavelets_tpu.parallel``.
"""
from . import config, io, ops
from .models import (Bump, DOG, Haar, MexicanHat, Morlet, Morse, MorseMNE,
                     MorseMultitaper, Paul, Shannon, Superlet, WaveletBase,
                     WaveletMode)
from .ops.baseline import Baseline, baseline_correct, baseline_tf
from .ops.ewt import ewt
from .ops.vmd import vmd
from .utils import (ArrayEpochs, EpochsWavelet, Parallel, RawWavelet,
                    Sequence,
                    Report,
                    compose, dict_map, plot_microstates, plot_tf,
                    plot_topomap, plot_wavelet)

__version__ = "0.1.0"

__all__ = [
    # reference-parity surface (__init__.py:1-3 of the reference)
    "WaveletBase", "WaveletMode", "plot_tf", "plot_topomap",
    "plot_microstates", "Report", "Baseline",
    "Morse", "MorseMNE", "Morlet", "Haar", "MexicanHat", "Shannon",
    "ArrayEpochs", "EpochsWavelet", "RawWavelet",
    # additions
    "plot_wavelet", "baseline_correct", "baseline_tf", "ops", "config",
    "Parallel", "Sequence", "compose", "dict_map", "io",
    "Paul", "DOG", "Bump", "Superlet", "MorseMultitaper",
    # decomposition conveniences (ops.ewt / ops.vmd are the modules)
    "ewt", "vmd",
]
