from presto_tpu_torch.connectors.tpcds.connector import TpcdsConnector

__all__ = ["TpcdsConnector"]
