"""Service layer: façade, async orchestration, REST API (ref C22, C31-C34)."""
