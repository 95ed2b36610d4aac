"""Force-field pieces of the port: espaloma partial charges."""
