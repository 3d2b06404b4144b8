"""Utilities of the port: the fold logger, the results-dir bootstrap, batch scoring (predict) and the HTTP scoring server."""
