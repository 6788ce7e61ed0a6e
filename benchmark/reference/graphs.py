"""The reference decides every branch on the host: the portal path's
triangle fallback renders the fallen envs alone (`render/portal.py`)."""


def decides_on_device(t) -> bool:
    return False


def device_while(cond, body, runs: int) -> None:
    for _ in range(runs):
        body()
