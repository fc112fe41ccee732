"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, at the full
700 W power limit; the result line names the card, and a run on a card
set lower reads against the same peaks)."""

#: HBM3 bandwidth, bytes per second
HBM_BYTES_PER_S = 3.35e12
