"""Share of padding in HSTU's train inputs over the window (%): the epochs'
``pad_slots`` over all slots of their [batch, hstu_max_len] inputs. Nothing
to read in a cell that trains no HSTU."""


def read(run):
    h = run.records.get("hstu")
    if not h or not h["epochs"]:
        return None
    return 100.0 * sum(e["pad_slots"] for e in h["epochs"]) / sum(e["slots"] for e in h["epochs"])
