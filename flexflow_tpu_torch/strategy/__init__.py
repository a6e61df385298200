"""Strategy files: the reference's protobuf wire format and the DLRM
strategy generators."""

from .proto import (StrategyParseError, dumps, load_strategy_file, loads,
                    save_strategy_file, strategy_digest)

__all__ = ["StrategyParseError", "dumps", "load_strategy_file", "loads",
           "save_strategy_file", "strategy_digest"]
