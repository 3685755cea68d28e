"""movie_recommendation_engine_tpu_torch — the PinSage embedding / retrieval
engine of ``movie_recommendation_engine_tpu`` ported to PyTorch and CUDA.

The JAX package stays the reference; this package imports neither JAX nor
it. Its two TPU kernels are hand-written CUDA kernels for Hopper
(``ops/csrc``), built with ``nvcc`` at first use. Entry points run on
``cuda`` unless the caller passes ``device="cpu"``. Ported so far: serving,
training, the at-scale pooling rungs, PPR neighborhoods, the IVF and LSH
indexes and the search benchmark; see ROADMAP.md for the rest.
"""

__version__ = "0.1.0"

from .config import Config, default_config, small_test_config  # noqa: F401


def __getattr__(name):
    # Lazy: `api` pulls in torch and the trainer; keep the bare import light.
    if name == "api":
        import importlib

        return importlib.import_module(".api", __name__)
    raise AttributeError(name)
