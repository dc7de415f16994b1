"""Models of the port: the GPT family's training forward and loss, its
train step, and its cached (serving) forward."""
