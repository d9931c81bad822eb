"""Training: the AdamW optimizer, the train step and gradient compression
(port of ``repro.training``)."""
