"""Kernel experiments on the card: the copy-rate probe and the DIA staging
variants (counterparts of ``experiments/pipeline_probe.py`` and
``experiments/kernel_variants.py``)."""
