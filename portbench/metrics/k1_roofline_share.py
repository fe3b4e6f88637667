"""K1's share of its roofline (readers.k1_roofline_share)."""
from portbench.readers import k1_roofline_share as read  # noqa: F401
