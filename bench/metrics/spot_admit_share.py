"""Share of the spot requests sent in the window that the gateway
admitted."""


def read(rec):
    sent = [r for r in rec["requests"]
            if r["klass"] == "spot" and r["sent"] < rec["seconds"]]
    if not sent:
        return None
    return 100.0 * sum(r["admitted"] for r in sent) / len(sent)
