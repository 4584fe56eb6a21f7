"""Preprocessing stages (the port of followmyhold_tpu/preprocess)."""
