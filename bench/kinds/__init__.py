"""Per-cell runners, one module a traffic kind."""
