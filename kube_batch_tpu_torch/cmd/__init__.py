"""The process entry, its options, leader election and the HTTP server."""
