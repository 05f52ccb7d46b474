"""Traffic drivers, one a kind; each mix is a JSON file beside them."""
