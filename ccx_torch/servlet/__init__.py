"""REST API layer (ref C32-C34: servlet, parameters, security, purgatory)."""
