"""File formats (copy of the pyratbay_tpu.io subset the slice uses)."""
