"""Each configuration's corpus as MovieLens CSVs, written once per checkout.

A configuration fixes its corpus (generator sizes and seed) as a dataset is
fixed. The first run in a checkout generates it with the frozen generator
(``corpus/synthetic.py``) and writes ``movies.csv``, ``ratings.csv`` and
``tags.csv`` under ``benchmarks/.cache/corpus/<key>/``; every run then loads
the CSVs through the port's own ingest (``data.source=movielens``), as a
user loads MovieLens. The directory is written under a temporary name and
renamed when complete, so a run cut off mid-write leaves no half corpus.
"""

from __future__ import annotations

import csv
import hashlib
import json
import os
import shutil
import time

from . import synthetic

CACHE = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), ".cache")
FILES = ("movies.csv", "ratings.csv", "tags.csv")


def corpus_dir(corpus: dict) -> str:
    key = hashlib.sha256(json.dumps(corpus, sort_keys=True).encode()).hexdigest()[:16]
    return os.path.join(CACHE, "corpus", key)


def write_csvs(d: str, raw: dict) -> None:
    with open(os.path.join(d, "movies.csv"), "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["movieId", "title", "genres"])
        w.writerows(zip(raw["movie_ids"].tolist(), raw["titles"], raw["genres"]))
    cols = [raw[k].tolist() for k in ("rating_user_ids", "rating_movie_ids", "rating_values",
                                      "rating_timestamps")]
    with open(os.path.join(d, "ratings.csv"), "w") as f:
        f.write("userId,movieId,rating,timestamp\n")
        f.writelines(f"{u},{m},{r:.1f},{t}\n" for u, m, r, t in zip(*cols))
    with open(os.path.join(d, "tags.csv"), "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["userId", "movieId", "tag", "timestamp"])
        w.writerows(zip(raw["tag_user_ids"].tolist(), raw["tag_movie_ids"].tolist(),
                        raw["tag_values"].tolist(), range(len(raw["tag_values"]))))


def ensure(corpus: dict) -> tuple[str, float | None]:
    """The directory of ``corpus``'s CSVs (``num_movies``, ``num_users``,
    ``num_ratings``, ``seed``), and the seconds spent generating and writing
    them in this call (None when they were there already)."""
    d = corpus_dir(corpus)
    if all(os.path.exists(os.path.join(d, f)) for f in FILES):
        return d, None
    t0 = time.perf_counter()
    raw = synthetic.generate(num_movies=corpus["num_movies"], num_users=corpus["num_users"],
                             num_ratings=corpus["num_ratings"], seed=corpus["seed"])
    tmp = f"{d}.{os.getpid()}.tmp"
    shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs(tmp)
    write_csvs(tmp, raw)
    shutil.rmtree(d, ignore_errors=True)
    os.replace(tmp, d)
    return d, time.perf_counter() - t0
