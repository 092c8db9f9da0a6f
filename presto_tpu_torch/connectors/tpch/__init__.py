from presto_tpu_torch.connectors.tpch.connector import TpchConnector

__all__ = ["TpchConnector"]
