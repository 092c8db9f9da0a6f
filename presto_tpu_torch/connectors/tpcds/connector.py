"""The built-in TPC-DS connector (generated data, never read from disk).

Counterpart of ``presto_tpu/connectors/tpcds/connector.py``, with the
same split/determinism contract as the port's TPC-H connector.
Fact-table FK columns carry NULLs: ``scan_numpy`` returns
``<col>$valid`` companions, and ``scan`` hands them to the Batch as
validity masks on the connector's device.
"""

from __future__ import annotations

from typing import Mapping, Sequence

import numpy as np

from presto_tpu_torch.batch import Batch, Dictionary
from presto_tpu_torch.connectors.tpcds import schema as S
from presto_tpu_torch.connectors.tpcds.generator import TpcdsGenerator
from presto_tpu_torch.devices import resolve_device
from presto_tpu_torch.spi import Split, batch_capacity, narrowed_schema, split_valids


class TpcdsConnector:
    name = "tpcds"

    DEFAULT_UNITS_PER_SPLIT = 1 << 17

    def __init__(self, sf: float = 1.0, seed: int = 20030115,
                 units_per_split: int | None = None, device="cuda"):
        self.sf = sf
        self.gen = TpcdsGenerator(sf, seed)
        self.units_per_split = units_per_split or self.DEFAULT_UNITS_PER_SPLIT
        self.device = resolve_device(device)

    # ---- metadata -------------------------------------------------------
    def tables(self) -> Sequence[str]:
        return list(S.TABLES)

    def schema(self, table: str):
        return S.TABLES[table]

    def dictionaries(self, table: str) -> Mapping[str, Dictionary]:
        return S.table_dicts(table)

    def row_count(self, table: str) -> int:
        return S.row_count(table, self.sf)

    def unique_keys(self, table: str):
        return S.UNIQUE_KEYS.get(table, ())

    def func_deps(self, table: str):
        return S.FUNC_DEPS.get(table, {})

    def physical_schema(self, table: str,
                        columns: Sequence[str] | None = None) -> dict:
        """Per-column physical types: TPC-DS declares no numeric column
        stats, so only dictionary-encoded VARCHAR columns narrow (to
        their code domain), as in the reference."""
        cols = list(columns) if columns is not None else list(S.TABLES[table])
        return narrowed_schema(
            {c: S.TABLES[table][c] for c in cols},
            lambda c: None,
            S.table_dicts(table),
        )

    # ---- splits ---------------------------------------------------------
    def splits(self, table: str, target_splits: int = 0) -> Sequence[Split]:
        units = self.gen.base_rows(table)
        per = self.units_per_split
        if target_splits:
            per = max(1, -(-units // target_splits))
        out = []
        for chunk, lo in enumerate(range(0, units, per)):
            hi = min(lo + per, units)
            out.append(Split(table, chunk, lo, hi, hi - lo))
        return out

    # ---- data -----------------------------------------------------------
    def scan_numpy(
        self, split: Split, columns: Sequence[str] | None = None
    ) -> Mapping[str, np.ndarray]:
        return self.gen.generate(split.table, split.chunk, split.lo, split.hi, columns)

    def scan(
        self,
        split: Split,
        columns: Sequence[str] | None = None,
        capacity: int | None = None,
    ) -> Batch:
        arrays, valids = split_valids(self.scan_numpy(split, columns))
        n = len(next(iter(arrays.values())))
        cap = capacity or batch_capacity(n)
        types = self.physical_schema(split.table, list(arrays))
        dicts = {c: d for c, d in S.table_dicts(split.table).items() if c in arrays}
        return Batch.from_numpy(arrays, types, capacity=cap, dictionaries=dicts,
                                valids=valids, device=self.device)

    # ---- whole-table convenience (tests / oracle) -----------------------
    def table_numpy(self, table: str, columns: Sequence[str] | None = None):
        parts = [self.scan_numpy(s, columns) for s in self.splits(table)]
        return {c: np.concatenate([p[c] for p in parts]) for c in parts[0]}
