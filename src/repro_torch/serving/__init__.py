"""repro_torch.serving"""
