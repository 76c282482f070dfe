"""Held-out validation of the port's detectors: the metrics and the
in-training evaluators (`eval.py`), the dataset readers (`data.py`), the
corruption suite (`corruptions.py`) and the validation CLI (`val.py`,
`python -m hockey_tpu_torch.train.val`). Training itself is not ported
yet."""
