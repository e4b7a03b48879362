"""Kernel experiments on the card: the copy-rate probe, the DIA staging
variants, the ablation of the ELL kernel and the gather probes
(counterparts of ``experiments/pipeline_probe.py``,
``experiments/kernel_variants.py``, ``experiments/gather_ablate.py`` and
``experiments/mosaic_gather_probe.py``)."""
