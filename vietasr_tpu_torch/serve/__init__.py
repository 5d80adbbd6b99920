from vietasr_tpu_torch.serve.app import AsrServer, serve

__all__ = ["AsrServer", "serve"]
