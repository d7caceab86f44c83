"""Distributed layer: mesh construction, all-to-all exchange, skew handling,
multi-device sort/shuffle via shard_map collectives."""
