"""The benchmark of the PyTorch and CUDA port, ``nsof_tpu_torch``, on one
NVIDIA H100: ``python -m benchmark.run --workload <cell> --seed <n>
--seconds <s> --trace <0|1>`` (see ``benchmark/run.py``)."""
