"""The frozen generator against the program's on one seed."""

import numpy as np

from benchmarks.corpus import synthetic as frozen
from movie_recommendation_engine_tpu_torch.graph import synthetic as program


def test_frozen_generator_equals_the_programs():
    a = frozen.generate(num_movies=300, num_users=500, num_ratings=20000, seed=42)
    b = program.generate(num_movies=300, num_users=500, num_ratings=20000, seed=42)
    assert a.keys() == b.keys()
    for k in a:
        assert np.array_equal(np.asarray(a[k]), np.asarray(b[k])), k
