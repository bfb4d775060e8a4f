"""Experiment CLIs (``python -m dgmc_tpu_torch.experiments.<name>``)."""
