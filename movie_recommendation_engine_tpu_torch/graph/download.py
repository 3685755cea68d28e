"""MovieLens dataset downloader and integrity check (stdlib only).

Port of ``movie_recommendation_engine_tpu/graph/download.py`` (reference
``download_dataset.py:19-153``): streams the ML-25M archive with progress,
extracts it, and checks that the four CSVs are there. Without network
access it says so and points at the synthetic data source.
"""

from __future__ import annotations

import os
import urllib.request
import zipfile

ML_25M_URL = "https://files.grouplens.org/datasets/movielens/ml-25m.zip"
REQUIRED_CSVS = ("movies.csv", "ratings.csv", "tags.csv", "links.csv")


def verify_dataset(data_dir: str) -> bool:
    """All four CSVs present (``download_dataset.py:75-105``)?"""
    return all(os.path.exists(os.path.join(data_dir, f)) for f in REQUIRED_CSVS)


def download_file(url: str, dest: str, chunk_size: int = 1 << 20) -> bool:
    """Streamed download with progress; False (with a message) when it
    fails, as it does without network access."""
    os.makedirs(os.path.dirname(os.path.abspath(dest)), exist_ok=True)
    try:
        with urllib.request.urlopen(url, timeout=30) as resp, open(dest, "wb") as f:
            total = int(resp.headers.get("Content-Length") or 0)
            done = 0
            while chunk := resp.read(chunk_size):
                f.write(chunk)
                done += len(chunk)
                if total:
                    print(f"\r  {done / 1e6:.1f}/{total / 1e6:.1f} MB", end="")
        print()
        return True
    except OSError as e:            # URLError, timeouts, refused connections, disk
        print(f"download failed ({type(e).__name__}: {e}). Without network access, "
              "use --set data.source=synthetic instead.")
        return False


def extract_zip(zip_path: str, dest_dir: str) -> None:
    with zipfile.ZipFile(zip_path) as z:
        z.extractall(dest_dir)


def download_ml25m(data_dir: str) -> bool:
    """Download, extract into ``data_dir``'s parent (the archive holds an
    ``ml-25m/`` folder) and verify (``download_dataset.py:107-153``)."""
    if verify_dataset(data_dir):
        print(f"dataset already present at {data_dir}")
        return True
    parent = os.path.dirname(os.path.abspath(data_dir)) or "."
    zip_path = os.path.join(parent, "ml-25m.zip")
    if not os.path.exists(zip_path):
        print(f"downloading {ML_25M_URL} ...")
        if not download_file(ML_25M_URL, zip_path):
            return False
    print("extracting ...")
    extract_zip(zip_path, parent)
    ok = verify_dataset(data_dir)
    print("verification:", "OK" if ok else "MISSING FILES")
    return ok
