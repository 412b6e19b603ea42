"""The benchmark of the PyTorch and CUDA port ``radar_tpu_torch``: one
cell, one run, ``python3 -m portbench.run --workload <cell> --seed <n>
--seconds <s> --trace <0|1>`` from the root of a checkout."""
