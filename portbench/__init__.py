"""The benchmark of `sift_tpu_torch` on one CUDA card: `python3
portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>`
(see README.md)."""
