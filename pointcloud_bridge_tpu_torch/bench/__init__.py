"""Cross-model benchmark harness and the convergence run of the port
(counterpart of pointcloud_bridge_tpu/bench: ``eva_model`` and
``convergence_parity``; the JAX package's TPU and relay probes have no
counterpart)."""

from .eva_model import evaluate_model, run_benchmark, save_results_csv

__all__ = ["evaluate_model", "run_benchmark", "save_results_csv"]
