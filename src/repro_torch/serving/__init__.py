"""Host-side serving over one index: QueryServer and QueryResult."""
