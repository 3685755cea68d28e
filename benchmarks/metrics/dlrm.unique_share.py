"""Share of the window's bag lookups that reached a row no earlier lookup of
the same bag and step had reached (%): the epochs' ``unique_rows`` over
their ``lookups``, the program's device counters read once an epoch. The
compact backward and the row-wise update touch that many rows. Nothing to
read in a cell that trains no DLRM."""


def read(run):
    h = run.records.get("dlrm")
    if not h or not h["epochs"]:
        return None
    lookups = sum(e["lookups"] for e in h["epochs"])
    return 100.0 * sum(e["unique_rows"] for e in h["epochs"]) / lookups if lookups else None
