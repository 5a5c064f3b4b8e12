"""setup_s: host seconds from the process's start to the first timed
solve or request: inputs drawn, the program built, loaded and warmed."""


def read(obs):
    return obs.get("setup_s")
