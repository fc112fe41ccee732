"""The benchmark of ``repro_torch``, the PyTorch and CUDA port: HBMC-ICCG
solves and the solver service on the H100 (``python3 portbench/run.py
--workload <name> --seed <n> --seconds <s> --trace <0|1>``)."""
