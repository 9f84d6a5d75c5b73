"""The yardstick of the kernel rooflines: the card's published figures
(`peaks.json`, frozen) and the bytes the algorithm must move in one
iteration, counted from the graph's and the Shuffle's own sizes.

Every input word is counted read once and every output word written once
(4 bytes a float32 value, per query column B), whatever the kernel reads
again; the port's index tables (slot, position and gather tables) are not
counted, so a redesign of them leaves the yardstick where it is. All three
kernels do a few integer or float operations per word, so their bound is
the bytes over the card's HBM rate.

Sizes (`counts`): n vertices, nnz CSR entries, M deliveries (values a
Reducer needs and did not Map), P of them carried by coded multicasts,
L = M - P unicast leftovers, coded_bits the multicast bits of one Shuffle
(each coded word XORs r segments of T / r bits), B query columns.
"""
from __future__ import annotations

import json
import pathlib

WORD = 4
PEAKS = pathlib.Path(__file__).with_name("peaks.json")


def card(device_name: str) -> dict:
    """The published figures of the card CUDA names `device_name`; raises
    for a card the table does not hold."""
    cards = json.loads(PEAKS.read_text())["cards"]
    for c in cards:
        if c["match"] in device_name:
            return c
    raise ValueError(f"no published figures for {device_name!r}; known: "
                     f"{[c['match'] for c in cards]}")


def encode_bytes(c: dict) -> int:
    """K1: read each delivered value once (M), write the coded segments
    (coded_bits / 8) and the unicast words (L)."""
    return c["B"] * (WORD * c["M"] + c["coded_bits"] // 8 + WORD * c["L"])


def decode_bytes(c: dict) -> int:
    """K2: read the coded segments and unicast words once, read the side
    values each receiver strips (the P coded values, each once), write the
    M delivered values."""
    return c["B"] * (c["coded_bits"] // 8 + WORD * c["L"] + WORD * c["P"]
                     + WORD * c["M"])


def shuffle_bytes(c: dict) -> int:
    """K1 + K2 of one Shuffle."""
    return encode_bytes(c) + decode_bytes(c)


def reduce_bytes(c: dict) -> int:
    """K3: read the nnz values of the rows (local and delivered) and the
    n + 1 row offsets once, write the n sums."""
    return WORD * (c["B"] * c["nnz"] + c["n"] + 1 + c["B"] * c["n"])


def roofline_pct(nbytes_per_iter: int, iterations: int, device_s: float,
                 figures: dict) -> float | None:
    """The share (%) of its bound that a kernel reached: the least time
    the card needs for `iterations` x `nbytes_per_iter` bytes over the
    kernel's summed device seconds. None when the kernel never ran."""
    if device_s <= 0.0 or iterations <= 0:
        return None
    bound_s = nbytes_per_iter * iterations / figures["hbm_bytes_per_s"]
    return 100.0 * bound_s / device_s
