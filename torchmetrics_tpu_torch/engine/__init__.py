"""Engine layer of the port: reduction signatures (CSE), the packed epoch sync and its counters."""
