"""Sharding rules and activation constraints of the port (mirrors
``repro.sharding``), on ``DeviceMesh`` and DTensor."""
