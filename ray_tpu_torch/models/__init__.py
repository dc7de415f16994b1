"""Models of the port: the GPT family's cached (serving) forward."""
