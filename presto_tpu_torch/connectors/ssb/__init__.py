from presto_tpu_torch.connectors.ssb.connector import SsbConnector

__all__ = ["SsbConnector"]
