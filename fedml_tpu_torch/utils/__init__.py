"""Device selection, parameter conversion and dict-of-tensor arithmetic."""
