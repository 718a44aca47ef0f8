from setuptools import find_packages, setup

setup(
    name='ninwavelets_tpu',
    version='0.1.0',
    description='Analytic-wavelet transform engine for accelerators (JAX/XLA/Pallas)',
    long_description='Frequency-domain wavelet banks (Generalized Morse, '
                     'Morlet/Gabor, Shannon, MexicanHat, Haar) synthesized '
                     'on device; CWT as batched FFT x bank x iFFT; fused '
                     'power/ITC/baseline; multi-chip sharding via pjit.',
    install_requires=['jax', 'numpy'],
    extras_require={
        'plot': ['matplotlib'],
        'mne': ['mne'],
        'test': ['pytest', 'scipy'],
    },
    packages=find_packages(include=['ninwavelets_tpu', 'ninwavelets_tpu.*']),
    python_requires='>=3.10',
)
