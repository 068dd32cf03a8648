"""volume_s: the window's seconds per volume completed, each volume
ending with its flow solution on the host."""


def read(run):
    done = run.attempted - run.failed
    return run.window_s / done if done else None
