"""General drivers: each runs every cell whose traffic file names it,
from the parameters in that file and the configuration's file."""
