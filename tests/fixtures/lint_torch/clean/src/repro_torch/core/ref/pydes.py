class PyDES:
    def __init__(self):
        self.t = 0

    def _complete(self):
        return self.t

    def run(self):
        return self._complete()
