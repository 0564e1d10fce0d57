"""The benchmark's plain reference: scene and renderer, trajectory and map
arithmetic, and a plain ORB. Imports nothing of the program."""
