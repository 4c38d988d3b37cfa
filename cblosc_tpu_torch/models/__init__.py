"""Codec registry of the port (counterpart of cblosc_tpu/models)."""
