"""Configuration parsing (copy of pyratbay_tpu.config)."""
