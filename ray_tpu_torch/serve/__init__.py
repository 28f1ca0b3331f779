"""ray_tpu_torch.serve — the serving plane of the port (`serve.llm`)."""
