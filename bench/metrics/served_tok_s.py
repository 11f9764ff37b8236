"""Prompt tokens whose prefill completed inside the window plus output
tokens emitted inside it, over all tenants, per second of the window:
in a cell above the knee, what the replica completes."""
from harness.readings import served_tok_s as read  # noqa: F401
