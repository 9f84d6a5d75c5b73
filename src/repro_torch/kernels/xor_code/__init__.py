"""XOR encode (K1) and decode (K2) of the coded Shuffle."""
