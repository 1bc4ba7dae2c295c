from smirk_tpu_torch.train.trainer import SmirkSystem  # noqa: F401
