import importlib


def main():
    return importlib.import_module("jaxlib")
