"""``served_tok_s`` in a cell below the knee, where it equals the
offered load while the system keeps up: a drop means it fell behind."""
from harness.readings import served_tok_s as read  # noqa: F401
