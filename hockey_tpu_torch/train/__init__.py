"""Training and held-out validation of the port's detectors: the
assigner (`assigner.py`), the losses (`losses.py`), the train step, EMA
and precise-BN (`trainer.py`), the datasets and host augmentations
(`data.py`), the device-resident augmentations (`device_aug.py`), the
train CLI (`loop.py`, `python -m hockey_tpu_torch.train.loop`), the
metrics and in-training evaluators (`eval.py`), the corruption suite
(`corruptions.py`) and the validation CLI (`val.py`, `python -m
hockey_tpu_torch.train.val`)."""
