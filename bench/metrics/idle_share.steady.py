"""``idle_share`` in a cell below the knee, whose tails swing with the
host's pace more than any bound holds and are read per layer there: it
moves the cell's end-to-end rate, ``served_tok_s.below_knee``."""
from harness.cell import reader

read = reader("idle_share")
