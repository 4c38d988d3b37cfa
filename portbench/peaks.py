"""The table of peaks: what each card can do at most, from its data sheet.

A roofline share divides the least time the card could take for a
call's work (its bytes over the peak bandwidth) by the device time the
call took. Shares are stated against the data sheet's peak, with the
card's power limit printed beside every run (harness.card_line).
"""

# torch.cuda.get_device_name() -> HBM bytes per second (NVIDIA H100 SXM
# data sheet: 80 GB of HBM3 at 3.35 TB/s, at the full 700 W)
HBM_BYTES_PER_S = {
    "NVIDIA H100 80GB HBM3": 3.35e12,
}


def hbm_bytes_per_s(kind: str):
    """The card's peak bandwidth, or None for a card not in the table."""
    return HBM_BYTES_PER_S.get(kind)
