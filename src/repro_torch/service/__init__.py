"""Request results for the query API."""
