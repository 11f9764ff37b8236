"""``prefill_graphed_share`` in the cell below the knee, where it moves
the cell's end-to-end rate, ``served_tok_s.below_knee``."""
from harness.cell import reader

read = reader("prefill_graphed_share")
