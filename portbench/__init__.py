"""The benchmark of the PyTorch/CUDA port (``cblosc_tpu_torch``): byte-API
write and read streams on one card. Run a cell with
``python3 portbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` from the root of a checkout."""
