"""The serving plane's host-side pieces ported so far: structure and
envelope binning (:mod:`.binning`), which the batched engine
(``engine/batch.py``) reads."""
