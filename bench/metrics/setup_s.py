"""Seconds from the start of the process to the first due request."""


def read(rec):
    return rec["setup_s"]
