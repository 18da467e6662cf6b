from repro_torch.train.serve_step import ServeSetup  # noqa: F401
