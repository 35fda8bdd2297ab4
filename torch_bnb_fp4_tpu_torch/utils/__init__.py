"""Device selection, synthetic models and timing."""
