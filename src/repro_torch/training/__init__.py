"""Training on the port: AdamW, the synthetic data pipeline, checkpoints in
the reference's bundle format, and the train loop (port of
``repro/training``)."""
