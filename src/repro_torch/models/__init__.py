"""Dense GQA transformer of the port (mirrors ``repro.models``)."""
