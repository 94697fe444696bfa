"""The metric compose_convert_us: the stage chain's composition and
conversion stages together, median microseconds."""
from pirbench.readers import chain_us


def read(run):
    return chain_us(run, "composition", "conversion")
