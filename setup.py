"""Packaging for unet-segment-tpu.

Console scripts mirror (and extend) the reference's unet-train /
unet-predict entry points (reference setup.py:56-61)."""

from pathlib import Path

from setuptools import find_packages, setup

README = Path(__file__).parent / 'README.md'

setup(
    name='unet-segment-tpu',
    version='0.1.0',
    description=('TPU-native JAX/Flax framework for lung-tumor '
                 'segmentation (UNet / Attention U-Net)'),
    long_description=README.read_text() if README.exists() else '',
    long_description_content_type='text/markdown',
    python_requires='>=3.10',
    packages=find_packages(include=['unet_tpu', 'unet_tpu.*',
                                    'unet_tpu_torch', 'unet_tpu_torch.*']),
    install_requires=[
        'jax>=0.4.30',
        'flax>=0.8',
        'optax>=0.2',
        'orbax-checkpoint',
        'numpy',
        'Pillow',
        'PyYAML',
    ],
    extras_require={
        'plots': ['matplotlib'],
        'toolkits': ['kagglehub', 'nibabel'],
        'dev': ['pytest', 'torch'],
    },
    entry_points={
        'console_scripts': [
            'unet-train=unet_tpu.cli.train:main',
            'unet-predict=unet_tpu.cli.predict:main',
            'unet-overfit-test=unet_tpu.cli.overfit:main',
            'unet-export-torch=unet_tpu.cli.export_torch:main',
            'unet-serve=unet_tpu.cli.serve:main',
        ],
    },
)
