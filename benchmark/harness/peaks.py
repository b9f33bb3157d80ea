"""The card's peaks, and the arithmetic of a share of them.

The DP kernels are integer-bound: a cell costs OPS_PER_CELL int32
operations, and the card runs 64 INT32 lanes a streaming multiprocessor
a clock, so its integer rate is SMs x 64 x the maximum SM clock, both
read on the card (the count of operations a cell and the rate are those of
`chip_smoke.py`'s `bound` / `real_cells`, copied)."""

from __future__ import annotations

import subprocess

INT32_LANES_PER_SM = 64
OPS_PER_CELL = 25


def read_card(torch) -> dict:
    """Name, SMs, maximum SM clock and power limit of card 0."""
    props = torch.cuda.get_device_properties(0)
    card = {"name": torch.cuda.get_device_name(0),
            "sms": props.multi_processor_count}
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm,power.limit",
         "--format=csv,noheader,nounits"],
        capture_output=True, text=True, timeout=60)
    clk, watts = (smi.stdout.strip().splitlines() or [","])[0].split(",")[:2]
    card["sm_hz"] = float(clk) * 1e6
    card["power_limit_w"] = float(watts)
    return card


def int32_ops_per_s(card: dict) -> float:
    return card["sms"] * INT32_LANES_PER_SM * card["sm_hz"]


def cells_roofline_pct(cells: int, kernel_s: float, card: dict):
    """Share, in %, of the integer bound that `cells` real DP cells set
    for `kernel_s` seconds of device time; None with nothing to read."""
    if cells <= 0 or kernel_s <= 0:
        return None
    return 100.0 * cells * OPS_PER_CELL / int32_ops_per_s(card) / kernel_s
